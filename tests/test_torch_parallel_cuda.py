"""The synchronized BatchNorm of the port (`models/backbones/common.py`,
`_SyncBatchNorm`) on the card, against `torch.native_batch_norm`.

Marked `cuda`: it needs an NVIDIA GPU and skips without one. On the machine
with the card:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py`.

On the CPU the synchronized BatchNorm takes its f64 branch
(`tests/test_torch_parallel.py` holds it over two gloo ranks). On the card it
runs PyTorch's fused BatchNorm kernels (`batch_norm_stats`,
`batch_norm_elemt`, `batch_norm_backward_reduce`, `batch_norm_backward_elemt`
with the count of all ranks), which only this file and `chip_smoke.py`
phase 15 run. Here one rank in an NCCL process group of world size 1: the
output, the input, weight and bias gradients and the running statistics
(flax's: the biased variance) against `torch.native_batch_norm`'s autograd
on the same batch, in f32, within 1e-5 of the largest value of each, in
both memory formats.
"""

import socket

import pytest
import torch

from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d
from neuralnet_tracker_traincode_torch.parallel.distributed import init_from_env

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture(scope="module")
def one_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the synchronized BatchNorm's card branch and NCCL)")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = pytest.MonkeyPatch()
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        env.setenv(k, v)
    try:
        dp, dev = init_from_env("cuda")
    finally:
        env.undo()
    yield dp, dev
    dp.close()


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", [(64, 32, 65, 65), (64, 1024, 5, 5), (3, 7, 4, 6), (5, 3, 1, 1)])
def test_sync_batchnorm_on_the_card_is_torch_batchnorm(one_rank, shape, channels_last):
    dp, dev = one_rank
    layout = torch.channels_last if channels_last else torch.contiguous_format
    C, g = shape[1], torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=g) * 3 + 1).to(dev).contiguous(memory_format=layout)
    dy = torch.randn(shape, generator=g).to(dev).contiguous(memory_format=layout)
    weight, bias = (torch.rand(C, generator=g) + 0.5).to(dev), torch.randn(C, generator=g).to(dev)

    xr, wr, br = x.clone().requires_grad_(), weight.clone().requires_grad_(), bias.clone().requires_grad_()
    y_ref, mean, invstd = torch.native_batch_norm(xr, wr, br, None, None, True, 0.0, 1e-5)
    y_ref.backward(dy)

    bn = BatchNorm2d(C).to(dev)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.sync = dp
    xs = x.clone().requires_grad_()
    y = bn(xs)
    y.backward(dy)

    var = invstd.double().pow(-2) - 1e-5  # biased
    for name, got, want in [("output", y, y_ref), ("input gradient", xs.grad, xr.grad),
                            ("weight gradient", bn.weight.grad, wr.grad), ("bias gradient", bn.bias.grad, br.grad),
                            ("running mean", bn.running_mean, 0.1 * mean),
                            ("running variance", bn.running_var, 0.9 + 0.1 * var)]:
        got, want = got.detach().double(), want.detach().double()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= TOL, f"{name} at {shape}, channels_last={channels_last}: {err:.3e} of the largest value"
