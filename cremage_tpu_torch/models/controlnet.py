"""ControlNet (the port of cremage_tpu/models/controlnet.py).

Architecture contract: reference `modules/cldm/cldm.py` ControlNet: a copy
of the UNet's encoder half (input_blocks and middle_block, built from the
port's own ResBlock, SpatialTransformer and Downsample, so kernels K1 and
K2 run in it) whose block outputs pass through 1x1 "zero" convolutions,
plus a hint network that maps the control image (in [0, 1], at 8x the
latent size) down to the latent resolution (strides 1,1,2,1,2,1,2 with
16,16,32,32,96,96,256 channels, then model_channels). It returns one
residual per input block and one for the middle block, which the UNet adds
to its skips and its middle output (`UNetModel.forward(control=)`).

Module names follow the checkpoint keys under `control_model.`:
input_hint_block.{0,2,...,14}, zero_convs.{i}.0, middle_block_out.0,
time_embed.{0,2}, input_blocks.*, middle_block.*.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import Conv2d, timestep_embedding
from cremage_tpu_torch.models.unet import UNetConfig, encoder_blocks, run_layers

PREFIX_CONTROLNET = "control_model."

# (out channels, stride) of the hint network's SiLU-activated convs; the
# last conv (input_hint_block.14) maps to model_channels
HINT_SPEC = [(16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2)]


class ControlNet(nn.Module):
    """forward(x NCHW latents, hint NCHW [0, 1], t (B,), context) ->
    (input-block residuals, middle residual), NCHW in the compute dtype.
    `cfg.in_channels` is the latents' channels (4)."""

    def __init__(self, cfg: UNetConfig, hint_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        hint: List[nn.Module] = []
        ch = hint_channels
        for out, stride in HINT_SPEC:
            hint += [Conv2d(ch, out, 3, stride=stride, padding=1), nn.Identity()]
            ch = out
        hint.append(Conv2d(ch, mc, 3, padding=1))
        self.input_hint_block = nn.Sequential(*hint)
        (self.time_embed, self.input_blocks, self.middle_block, chans,
         _) = encoder_blocks(cfg, cfg.in_channels)
        self.zero_convs = nn.ModuleList(
            nn.Sequential(Conv2d(c, c, 1)) for c in chans)
        self.middle_block_out = nn.Sequential(Conv2d(chans[-1], chans[-1], 1))

    def forward(self, x, hint, timesteps, context
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        dtype = self.cfg.dtype
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels).to(dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        h = hint.to(dtype)
        for i in range(0, len(HINT_SPEC) * 2, 2):
            h = F.silu(self.input_hint_block[i](h))
        guided = self.input_hint_block[len(HINT_SPEC) * 2](h)
        context = context.to(dtype)
        h = self.input_blocks[0][0](x.to(dtype)) + guided
        outs = [self.zero_convs[0][0](h)]
        for layers, zero in zip(self.input_blocks[1:], self.zero_convs[1:]):
            h = run_layers(layers, h, emb, context)
            outs.append(zero[0](h))
        h = run_layers(self.middle_block, h, emb, context)
        return outs, self.middle_block_out[0](h)
