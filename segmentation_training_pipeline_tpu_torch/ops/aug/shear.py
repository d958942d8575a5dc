"""Shear resample along the last axis: one pass of the unfused warp.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/
pallas_shear.py`` (``shear_pass_tpu``).  Every line of a (B, C, L, N) f32
tensor moves by its own displacement ``offs[b, l]``: the source of output
element q is ``q + offs``.  Image channels (kind 0) blend the two taps
bilinearly and clamp at the edges of the original frame (``norig`` wide,
shifted by ``src_shift`` inside the canvas); mask channels (kind 1) take
the upper tap when the fraction is at least 0.5, with no edge clamps.  Both
take ``fill`` where the source lies outside the original frame.

The CUDA kernel lives in ``csrc/shear.cu``.  Beside it is its plain PyTorch
version, which the wrapper runs for CPU tensors only; a CUDA tensor
launches the kernel or raises.  The kernel runs on a 3-D grid (planes B·C
on one axis, tiles of lines on another), so the wrapper refuses what a
grid axis cannot hold before any launch; it keeps no line in shared
memory, so a line may be as wide as memory allows.
"""

from __future__ import annotations

import torch

from ... import kernels as K

Tensor = torch.Tensor


def shear_pass_plain(x_bcln: Tensor, offs: Tensor, kinds: Tensor, norig: int,
                     src_shift: int, fill: float) -> Tensor:
    """Plain PyTorch shear: x (B, C, L, N) f32, offs (B, L) f32, kinds (C,)
    i32 → (B, C, L, N)."""
    b, c, l, n = x_bcln.shape
    dev = x_bcln.device
    kfloor = torch.floor(offs)
    frac = (offs - kfloor)[:, None, :, None]                     # (B,1,L,1)
    kmod = torch.remainder(kfloor.long(), n)                      # (B, L)
    q = torch.arange(n, device=dev)
    a = torch.remainder(q[None, None, :] + kmod[:, :, None], n)   # (B, L, N)
    a1 = torch.remainder(a + 1, n)
    out = torch.gather(x_bcln, 3, a[:, None].expand(b, c, l, n))
    nxt = torch.gather(x_bcln, 3, a1[:, None].expand(b, c, l, n))
    src = ((q.float()[None, None, :] + offs[:, :, None])
           - float(src_shift))[:, None]                           # (B,1,L,N)
    blend = (1.0 - frac) * out + frac * nxt
    blend = torch.where(src >= norig - 1.0, out, blend)
    blend = torch.where(src < 0.0, nxt, blend)
    near = torch.where(frac >= 0.5, nxt, out)
    res = torch.where((kinds == 1).view(1, c, 1, 1), near, blend)
    return torch.where((src < -0.5) | (src > norig - 0.5), fill, res)


def shear_pass(x_bcln: Tensor, offs: Tensor, kinds: Tensor, norig: int,
               src_shift: int, fill: float) -> Tensor:
    """The shear kernel on CUDA tensors; its plain version on CPU ones."""
    if x_bcln.device.type == "cpu":
        return shear_pass_plain(x_bcln, offs, kinds, norig, src_shift, fill)
    # no shared memory: a block walks a tile of lines of one plane
    K.check_block("shear", x_bcln, 0, x_bcln.shape[0] * x_bcln.shape[1])
    K.check_plane_args("shear", x_bcln, kinds, (offs,))
    b, c, l, n = x_bcln.shape
    if offs.dtype != torch.float32 or offs.shape != (b, l):
        raise ValueError(f"shear: offsets must be ({b}, {l}) float32, got "
                         f"{tuple(offs.shape)} {offs.dtype}")
    out = torch.empty_like(x_bcln)
    K.KERNELS["shear"].launch(x_bcln.data_ptr(), offs.data_ptr(),
                              kinds.data_ptr(), out.data_ptr(), b, c, l, n,
                              int(norig), int(src_shift), float(fill),
                              K.stream_of(x_bcln))
    return out
