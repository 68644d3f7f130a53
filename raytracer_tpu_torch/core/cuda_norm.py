"""The full FB agent's row kernel: wrapper, launch count and plain version.

``guide_norm(y, bias, ln, post)`` finishes one layer of the f32 guide
(``fb/fused_guide.py``) on a product's raw output ``y [R, D]``, in place:
``post(LN?(y + bias))``, where ``ln`` is the layer's ``networks.LayerNorm``
or None and ``post`` is None, ``"relu"`` or a residual tensor to add.  On
CUDA tensors it launches ``csrc/guide_norm.cu`` (one read and one write of
``y``, the residual read once) and raises on anything the kernel does not
take; on CPU tensors, and only there, it runs ``guide_norm_plain``: the
module path's own ops in their order (``Dense``'s bias add, the
``LayerNorm`` module, ``relu_`` or ``add_``), so a forward over it equals
the modules bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import native

WIDTHS = (128, 256, 512)
POST_CODES = {None: 0, "relu": 1}
POST_RESIDUAL = 2

Post = Union[None, str, torch.Tensor]


def guide_norm_plain(y: torch.Tensor, bias: torch.Tensor, ln=None,
                     post: Post = None) -> torch.Tensor:
    """``post(ln(y + bias))`` by the module path's ops, ``y`` updated in
    place as ``Dense`` updates its product."""
    x = y.add_(bias)
    if ln is not None:
        x = ln(x)
    if isinstance(post, torch.Tensor):
        return x.add_(post)
    return torch.relu_(x) if post == "relu" else x


def _check(y, bias, ln, post):
    if y.dim() != 2:
        raise ValueError(f"y must be [R, D], got {tuple(y.shape)}")
    D = y.shape[1]
    params = [("bias", bias)]
    if ln is not None:
        params += [("ln.scale", ln.scale), ("ln.bias", ln.bias)]
    for name, t in params:
        if tuple(t.shape) != (D,):
            raise ValueError(f"{name} must be [{D}], got {tuple(t.shape)}")
    if isinstance(post, torch.Tensor):
        if post.shape != y.shape:
            raise ValueError(f"residual {tuple(post.shape)} is not y's "
                             f"{tuple(y.shape)}")
    elif post not in POST_CODES:
        raise ValueError(f"post must be None, 'relu' or a residual tensor, "
                         f"not {post!r}")
    return params


def guide_norm(y: torch.Tensor, bias: torch.Tensor, ln=None,
               post: Post = None) -> torch.Tensor:
    """One layer's bias, LayerNorm and ReLU or residual on ``y`` in place:
    the kernel on CUDA tensors, ``guide_norm_plain`` on CPU tensors."""
    params = _check(y, bias, ln, post)
    dev = y.device
    if dev.type == "cpu":
        return guide_norm_plain(y, bias, ln, post)
    if dev.type != "cuda":
        raise ValueError(f"guide_norm runs on cuda or cpu, not {dev}")
    R, D = y.shape
    if D not in WIDTHS:
        raise ValueError(f"guide_norm's kernel takes widths {WIDTHS}, not "
                         f"{D}")
    tensors = [("y", y)] + params
    residual = post if isinstance(post, torch.Tensor) else None
    if residual is not None:
        tensors.append(("residual", residual))
    for name, t in tensors:
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: the kernel takes contiguous, 16-byte "
                             f"aligned float32 on {dev}, got {t.dtype} on "
                             f"{t.device}")
    if R == 0:
        return y
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.guide_norm_launch(
            y.data_ptr(), bias.data_ptr(),
            None if ln is None else ln.scale.data_ptr(),
            None if ln is None else ln.bias.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            R, D, POST_RESIDUAL if residual is not None else POST_CODES[post],
            stream)
    if err != 0:
        raise RuntimeError(f"guide_norm kernel launch failed: CUDA error "
                           f"{err}")
    guide_norm.launches += 1
    return y


guide_norm.launches = 0      # kernel launches in this process


def load() -> ctypes.CDLL:
    """The kernel's library, built and loaded at the first call (a guide
    calls this when it is built, so its first frame does not)."""
    lib = native.load("guide_norm").lib
    fn = lib.guide_norm_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib
