"""The face localizer network (counterpart of the JAX package's
`models/localizer.py`).

(B, 224, 288, 1) grayscale -> MNASNet-style inverted-residual stack -> a
2-channel map, NCHW inside. Channel 0 averages to the face logit; channel 1
is softmaxed into an attention map whose soft-argmax centre +- standard
deviation (scaled by the trainable `boxstddev.half_size`) gives the box.
Output (B, 5) = [logit, x0, y0, x1, y1], the box in [-1, 1] crop units.

Module names give the reference state-dict keys (`convnet.0.0.weight` ...
`convnet.14.bias`, `boxstddev.half_size`), the layout that the JAX
package's `models/torch_interop.py:convert_localizer_state_dict` reads.
`dtype=torch.bfloat16` runs the convolutions under autocast, as the JAX
model's `dtype=jnp.bfloat16` does; the final convolution's output is cast to
f32 and the logit, softmax and soft-argmax run in f32.
"""

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn

from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d, lecun_normal_
from neuralnet_tracker_traincode_torch.models.components import center_of_mass_and_std

# (out channels, kernel, stride, expansion) of the 12 inverted residuals
IR_CONFIG = [
    (12, 3, 2, 2), (12, 3, 1, 2),
    (20, 3, 2, 4), (20, 3, 1, 4), (20, 3, 1, 4),
    (32, 5, 2, 2), (32, 5, 1, 2), (32, 3, 1, 2), (32, 3, 1, 2),
    (56, 3, 2, 2), (56, 3, 1, 2), (56, 3, 1, 2),
]


class InvertedResidual(nn.Module):
    """MNASNet inverted residual block (expansion -> depthwise -> project);
    `layers` holds the reference's indices 0..7."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1, expansion_factor: int = 2,
                 momentum: float = 0.1):
        super().__init__()
        mid = in_ch * expansion_factor
        self.apply_residual = stride == 1 and in_ch == out_ch
        self.layers = nn.Sequential(
            nn.Conv2d(in_ch, mid, 1, bias=False),
            BatchNorm2d(mid, momentum),
            nn.ReLU(),
            nn.Conv2d(mid, mid, kernel_size, stride, kernel_size // 2, groups=mid, bias=False),
            BatchNorm2d(mid, momentum),
            nn.ReLU(),
            nn.Conv2d(mid, out_ch, 1, bias=False),
            BatchNorm2d(out_ch, momentum),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layers(x)
        return h + x if self.apply_residual else h


class BoxStddev(nn.Module):
    def __init__(self):
        super().__init__()
        self.half_size = nn.Parameter(torch.tensor(1.5))


class LocalizerNet(nn.Module):
    input_resolution = (224, 288)  # H x W

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # BatchNorm momentum: flax 0.9 == torch 0.1; the ds-sep conv's flax 0.999 == torch 0.001
        layers = [
            nn.Sequential(nn.Conv2d(1, 8, 3, 2, 1, bias=False), BatchNorm2d(8, 0.1), nn.ReLU()),
            nn.Sequential(
                nn.Conv2d(8, 8, 3, 1, 1, groups=8, bias=False), BatchNorm2d(8, 0.001), nn.ReLU(),
                nn.Conv2d(8, 8, 1, bias=False), BatchNorm2d(8, 0.001),
            ),
        ]
        in_ch = 8
        for out_ch, k, s, e in IR_CONFIG:
            layers.append(InvertedResidual(in_ch, out_ch, k, s, e, momentum=0.1))
            in_ch = out_ch
        layers.append(nn.Conv2d(in_ch, 2, 1, bias=True))
        self.convnet = nn.Sequential(*layers)
        self.boxstddev = BoxStddev()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's default init: lecun-normal kernels, zero biases; BatchNorm
        and `half_size` (1.5) stay as built."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()

    def _precision(self, device_type: str):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 224, 288, 1) whitened crops. Train/eval follows `self.training`."""
        assert x.shape[1] == 224 and x.shape[2] == 288, f"Bad input {tuple(x.shape)}"
        with self._precision(x.device.type):
            z = self.convnet(x.permute(0, 3, 1, 2))
        with torch.autocast(x.device.type, enabled=False):
            z = z.float()
            logit = torch.mean(z[:, 0], dim=(1, 2))
            B, H, W = z[:, 1].shape
            attn = torch.softmax(z[:, 1].reshape(B, -1), dim=1).reshape(B, H, W)
            mean, std = center_of_mass_and_std(attn, self.boxstddev.half_size)
            return torch.cat([logit[:, None], mean - std, mean + std], dim=-1)

    @staticmethod
    def inference_outputs(pred: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"hasface": torch.sigmoid(pred[:, 0]), "roi": pred[:, 1:]}

    def get_config(self) -> Dict[str, Any]:
        return {}
