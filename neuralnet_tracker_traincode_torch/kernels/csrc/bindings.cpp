// PyTorch bindings of the port's kernels: the only source that includes
// PyTorch's headers. The Python wrappers (kernels/*.py) validate shapes and
// types and allocate the outputs; these functions re-check what a wrong
// pointer would turn into a fault, launch on the current stream, and check
// the launch.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "nntc_kernels.h"

namespace {

void check(const torch::Tensor& t, torch::ScalarType dtype, const char* name) {
    TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
    TORCH_CHECK(t.scalar_type() == dtype, name, " has the wrong dtype ", t.scalar_type());
    TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void warp_roi_rotate(torch::Tensor img, torch::Tensor params, torch::Tensor out, int64_t out_size,
                     int64_t canvas_size, bool rotate, int64_t taps_x, int64_t taps_y, int64_t chunk,
                     int64_t band_rows) {
    check(img, torch::kUInt8, "images");
    check(params, torch::kFloat32, "params");
    check(out, torch::kFloat32, "out");
    TORCH_CHECK(img.dim() == 3 && params.size(0) == img.size(0) && params.size(1) == 6);
    TORCH_CHECK(out.numel() == img.size(0) * out_size * out_size);
    TORCH_CHECK(rotate || canvas_size == out_size, "without rotation the canvas is the crop");
    const c10::cuda::CUDAGuard guard(img.device());
    C10_CUDA_CHECK(nntc_warp_roi_rotate(img.data_ptr<uint8_t>(), params.data_ptr<float>(), out.data_ptr<float>(),
                                        (int)img.size(0), (int)img.size(1), (int)img.size(2), (int)out_size,
                                        (int)canvas_size, rotate ? 1 : 0, (int)taps_x, (int)taps_y, (int)chunk,
                                        (int)band_rows, at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void equalize(torch::Tensor x, torch::Tensor gate, torch::Tensor out) {
    check(x, torch::kFloat32, "images");
    check(gate, torch::kInt32, "gate");
    check(out, torch::kFloat32, "out");
    TORCH_CHECK(x.dim() == 2 && gate.numel() == x.size(0) && out.sizes() == x.sizes());
    const c10::cuda::CUDAGuard guard(x.device());
    C10_CUDA_CHECK(nntc_equalize(x.data_ptr<float>(), gate.data_ptr<int32_t>(), out.data_ptr<float>(),
                                 (int)x.size(0), (int)x.size(1), at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gaussian_noise(torch::Tensor x, torch::Tensor seeds, torch::Tensor sigma, torch::Tensor out, double offset) {
    check(x, torch::kFloat32, "images");
    check(seeds, torch::kInt32, "seeds");
    check(sigma, torch::kFloat32, "sigma");
    check(out, torch::kFloat32, "out");
    TORCH_CHECK(x.dim() == 2 && seeds.numel() == x.size(0) && sigma.numel() == x.size(0) &&
                out.sizes() == x.sizes());
    const c10::cuda::CUDAGuard guard(x.device());
    C10_CUDA_CHECK(nntc_gaussian_noise(x.data_ptr<float>(), seeds.data_ptr<int32_t>(), sigma.data_ptr<float>(),
                                       out.data_ptr<float>(), (int)x.size(0), (int)x.size(1), (float)offset,
                                       at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gaussian_noise_from_bits(torch::Tensor x, torch::Tensor bits1, torch::Tensor bits2, torch::Tensor sigma,
                              torch::Tensor out) {
    check(x, torch::kFloat32, "images");
    check(bits1, torch::kInt32, "bits1");
    check(bits2, torch::kInt32, "bits2");
    check(sigma, torch::kFloat32, "sigma");
    check(out, torch::kFloat32, "out");
    TORCH_CHECK(x.dim() == 2 && bits1.sizes() == x.sizes() && bits2.sizes() == x.sizes() &&
                sigma.numel() == x.size(0) && out.sizes() == x.sizes());
    const c10::cuda::CUDAGuard guard(x.device());
    C10_CUDA_CHECK(nntc_gaussian_noise_from_bits(x.data_ptr<float>(), bits1.data_ptr<int32_t>(),
                                                 bits2.data_ptr<int32_t>(), sigma.data_ptr<float>(),
                                                 out.data_ptr<float>(), (int)x.size(0), (int)x.size(1),
                                                 at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void jpeg_idct_pack(torch::Tensor slots, torch::Tensor lens, torch::Tensor qtables, torch::Tensor meta,
                    torch::Tensor out, int64_t pad) {
    check(slots, torch::kInt16, "slots");
    check(lens, torch::kUInt8, "lens");
    check(qtables, torch::kInt32, "qtables");
    check(meta, torch::kInt32, "meta");
    check(out, torch::kUInt8, "out");
    TORCH_CHECK(slots.dim() == 2 && slots.size(1) == 64 && lens.dim() == 1 && lens.size(0) == slots.size(0) &&
                meta.dim() == 2 && meta.size(1) >= 4 && qtables.dim() == 2 && qtables.size(0) == meta.size(0) &&
                qtables.size(1) == 64);
    TORCH_CHECK(out.numel() == meta.size(0) * pad * pad, "out must hold N x pad x pad bytes");
    const c10::cuda::CUDAGuard guard(slots.device());
    C10_CUDA_CHECK(nntc_jpeg_idct_pack(slots.data_ptr<int16_t>(), lens.data_ptr<uint8_t>(),
                                       qtables.data_ptr<int32_t>(), meta.data_ptr<int32_t>(), out.data_ptr<uint8_t>(),
                                       (long)slots.size(0), (int)meta.size(1), (int)meta.size(0), (int)pad,
                                       at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void jpeg_huffman_decode(torch::Tensor scan, torch::Tensor intervals, torch::Tensor tables, torch::Tensor meta,
                         torch::Tensor slots, torch::Tensor lens, torch::Tensor status, torch::Tensor stats,
                         torch::Tensor scratch, int64_t sequence_bits, int64_t subsequence_bits, int64_t bits_total,
                         int64_t subs, int64_t intervals_total) {
    check(scan, torch::kUInt8, "scan");
    check(intervals, torch::kInt32, "intervals");
    check(tables, torch::kInt32, "tables");
    check(meta, torch::kInt32, "meta");
    check(slots, torch::kInt16, "slots");
    check(lens, torch::kUInt8, "lens");
    check(status, torch::kInt32, "status");
    check(stats, torch::kInt32, "stats");
    check(scratch, torch::kInt64, "scratch");
    const int64_t N = meta.size(0);
    TORCH_CHECK(scan.dim() == 1 && intervals.dim() == 2 && intervals.size(1) == 4 && tables.dim() == 2 &&
                tables.size(1) == 804 && meta.dim() == 2 && meta.size(1) == 34 && slots.dim() == 2 &&
                slots.size(1) == 64 && lens.numel() == slots.size(0) && status.numel() == 4 * N &&
                stats.numel() == 3 * N);
    const int64_t T = tables.size(0), G = (subs + 31) / 32 + N;  // scratch_words
    TORCH_CHECK(scratch.numel() >= 2 + 3 * G + 5 * N + 1024 * T + 2048 * N + (intervals_total + N + 1) / 2,
                "scratch too small");
    const c10::cuda::CUDAGuard guard(scan.device());
    C10_CUDA_CHECK(nntc_jpeg_huffman_decode(
        scan.data_ptr<uint8_t>(), intervals.data_ptr<int32_t>(), tables.data_ptr<int32_t>(), meta.data_ptr<int32_t>(),
        slots.data_ptr<int16_t>(), lens.data_ptr<uint8_t>(), status.data_ptr<int32_t>(), stats.data_ptr<int32_t>(),
        reinterpret_cast<long long*>(scratch.data_ptr<int64_t>()), (int)N, (int)T, (int)sequence_bits,
        (int)subsequence_bits, (long)bits_total, (long)subs, (long)intervals_total,
        at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void stamp(torch::Tensor ring, torch::Tensor cursor, int64_t kind, int64_t arg) {
    check(ring, torch::kInt64, "ring");
    check(cursor, torch::kInt64, "cursor");
    TORCH_CHECK(ring.dim() == 2 && ring.size(0) > 0 && ring.size(1) == 2 && cursor.numel() == 1 &&
                cursor.device() == ring.device());
    TORCH_CHECK(kind >= 0 && kind < NNTC_STAMP_KINDS && arg >= 0, "no stamp of kind ", kind, " and argument ", arg);
    const c10::cuda::CUDAGuard guard(ring.device());
    C10_CUDA_CHECK(nntc_stamp(reinterpret_cast<long long*>(ring.data_ptr<int64_t>()),
                              reinterpret_cast<long long*>(cursor.data_ptr<int64_t>()), ring.size(0), (int)kind,
                              (long long)arg, at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void pose_heads(std::vector<torch::Tensor> slots, int64_t rows, bool backward) {
    TORCH_CHECK(slots.size() == nntc_heads::count, "the pose heads take ", (int)nntc_heads::count, " slots");
    void* ptr[nntc_heads::count];
    for (int i = 0; i < nntc_heads::count; ++i) {
        const torch::Tensor& t = slots[i];
        ptr[i] = nullptr;
        if (t.numel() == 0) continue;  // absent
        check(t, i == nntc_heads::set_id || i == nntc_heads::ticket ? torch::kInt32 : torch::kFloat32, "a slot");
        ptr[i] = t.data_ptr();
    }
    const torch::Tensor& quat = slots[nntc_heads::quat];
    TORCH_CHECK(quat.dim() == 2 && quat.size(1) == 4, "quat must be (B, 4)");
    const c10::cuda::CUDAGuard guard(quat.device());
    const int B = (int)quat.size(0);
    const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
    C10_CUDA_CHECK(backward ? nntc_pose_heads_backward(ptr, B, (int)rows, stream)
                            : nntc_pose_heads_forward(ptr, B, (int)rows, stream));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t jpeg_huffman_ctas_per_sm() {
    const int n = nntc_jpeg_huffman_ctas_per_sm();
    TORCH_CHECK(n > 0, "K5's occupancy query failed");
    return n;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
    m.def("warp_roi_rotate", &warp_roi_rotate, "K1: crop warp (uint8 source -> f32 crop)");
    m.def("equalize", &equalize, "K2: per-image histogram equalization, one cluster of 8 CTAs per image");
    m.def("gaussian_noise", &gaussian_noise, "K3: Philox-seeded gaussian noise, clip, + offset");
    m.def("gaussian_noise_from_bits", &gaussian_noise_from_bits, "K3: gaussian noise from injected bits");
    m.def("jpeg_idct_pack", &jpeg_idct_pack, "K4: JPEG dequantize, ISLOW IDCT, range limit, zero-padded batch");
    m.def("jpeg_huffman_decode", &jpeg_huffman_decode, "K5: JPEG Huffman decode of the Y scans into K4's slots");
    m.def("stamp", &stamp, "the tracer's stamp: (kind | arg << 8, %globaltimer) into the next slot of a ring");
    m.def("pose_heads", &pose_heads,
          "the pose heads after their linears: forward or backward, one launch, tensors by slot (kernels/heads.py)");
    m.def("jpeg_huffman_ctas_per_sm", &jpeg_huffman_ctas_per_sm, "K5: its decode CTAs an SM at most");
}
