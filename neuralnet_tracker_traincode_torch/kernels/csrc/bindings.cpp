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

void jpeg_idct_pack(torch::Tensor coeffs, torch::Tensor block_start, torch::Tensor qtables, torch::Tensor meta,
                    torch::Tensor out, int64_t pad) {
    check(coeffs, torch::kInt16, "coeffs");
    check(block_start, torch::kInt32, "block_start");
    check(qtables, torch::kInt32, "qtables");
    check(meta, torch::kInt32, "meta");
    check(out, torch::kUInt8, "out");
    TORCH_CHECK(coeffs.dim() == 1 && block_start.dim() == 1 && block_start.size(0) >= 1 && meta.dim() == 2 &&
                meta.size(1) == 4 && qtables.dim() == 2 && qtables.size(0) == meta.size(0) && qtables.size(1) == 64);
    TORCH_CHECK(out.numel() == meta.size(0) * pad * pad, "out must hold N x pad x pad bytes");
    const c10::cuda::CUDAGuard guard(coeffs.device());
    C10_CUDA_CHECK(nntc_jpeg_idct_pack(coeffs.data_ptr<int16_t>(), block_start.data_ptr<int32_t>(),
                                       qtables.data_ptr<int32_t>(), meta.data_ptr<int32_t>(), out.data_ptr<uint8_t>(),
                                       (long)coeffs.size(0), (long)block_start.size(0) - 1, (int)meta.size(0),
                                       (int)pad, at::cuda::getCurrentCUDAStream()));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
    m.def("warp_roi_rotate", &warp_roi_rotate, "K1: crop warp (uint8 source -> f32 crop)");
    m.def("equalize", &equalize, "K2: per-image histogram equalization, one cluster of 8 CTAs per image");
    m.def("gaussian_noise", &gaussian_noise, "K3: Philox-seeded gaussian noise, clip, + offset");
    m.def("gaussian_noise_from_bits", &gaussian_noise_from_bits, "K3: gaussian noise from injected bits");
    m.def("jpeg_idct_pack", &jpeg_idct_pack, "K4: JPEG dequantize, ISLOW IDCT, range limit, zero-padded batch");
}
