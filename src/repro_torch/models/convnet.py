"""AlexNet with dMath's hybrid parallelism — the paper's own workload (§4),
ported from the reference's ``models/convnet.py``.

Conv features run data-parallel (activations dominate), the FC classifier
runs model-parallel (parameters dominate) — Krizhevsky's one-weird-trick
[8], which dMath generalizes.

The reference's semantics, on this package's devices:

- Images are NHWC and conv weights HWIO, as in the reference (so
  :func:`~repro_torch.models.params.from_jax` carries its weights as they
  are).  Each conv runs in fp32 (``F.conv2d`` on NCHW views, TF32 off for
  the call and its backward), bias and ReLU in fp32, the result rounded
  to the weights' dtype before the 3 x 3 / 2 VALID max-pool.  The conv is
  XLA's ``conv_general_dilated`` in the reference, not a Pallas kernel.
- SAME padding is XLA's: ``total = max((ceil(H/s) - 1) s + k - H, 0)``
  rows, the smaller half above (conv0 at 224²: 3 above, 4 below), which
  ``F.conv2d``'s symmetric padding cannot express, so :func:`same_pad`
  pads explicitly.
- The flatten is over (h, w, c), the reference's NHWC order, into
  ``fc1_w``'s rows.  ``fc1 -> ReLU -> fc2 -> ReLU -> fc3`` are
  :func:`~repro_torch.core.precision.matmul` products (the GEMM kernel),
  and the loss is the mean of fp32 ``logsumexp - gold``.

On a ``(data, model)`` mesh each rank holds its blocks (the port's layer
is SPMD on blocks) and performs what GSPMD inserts in the reference: the
batch splits over ``plan.batch_axes``, the flatten is constrained to
``(batch_axes, None)``, ``fc1_w`` is split on columns and ``fc2_w`` on
rows over ``plan.tp_axis`` (Megatron's f and g: ``copy_ad`` before fc1,
whose backward sums the input's gradient over the model axis, and
``psum_ad`` of fc2's fp32 partial sums in rank order), ``fc3_w`` is
replicated, and :func:`value_and_grad` sums every leaf's gradient over
the batch axes (every leaf is replicated there).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.core.layout import Layout, batch_block, constrain
from repro_torch.models.params import ParamSpec, tree_init

Params = Dict[str, torch.Tensor]

# (out_c, kernel, stride, pool) per conv stage — classic AlexNet
CONV_STAGES = [
    (96, 11, 4, True),
    (256, 5, 1, True),
    (384, 3, 1, False),
    (384, 3, 1, False),
    (256, 3, 1, True),
]
POOL, POOL_STRIDE = 3, 2


def param_specs(plan, mesh, *, n_classes: int = 1000,
                img_channels: int = 3, fc_dim: int = 4096,
                scale_down: int = 1) -> Dict[str, Any]:
    """The conv stack's specs (replicated) and ``_meta``: the last conv's
    channels, the FC width and the classes (the FC specs depend on the
    image size: :func:`init`)."""
    specs: Dict[str, Any] = {}
    c_in = img_channels
    for i, (c_out, k, s, _) in enumerate(CONV_STAGES):
        c_out = max(8, c_out // scale_down)
        specs[f"conv{i}_w"] = ParamSpec(
            (k, k, c_in, c_out), scale=0.05, layout=Layout.replicated(4))
        specs[f"conv{i}_b"] = ParamSpec((c_out,), init="zeros",
                                        layout=Layout((None,)))
        c_in = c_out
    fc = max(16, fc_dim // scale_down)
    specs["_meta"] = {"c_last": c_in, "fc": fc, "n_classes": n_classes}
    return specs


def feature_shape(img_size: int, c_last: int) -> Tuple[int, int, int]:
    """(h, w, c) of the conv stack's output for ``img_size``² images."""
    h = img_size
    for _, _, s, pool in CONV_STAGES:
        h = -(-h // s)                              # SAME
        if pool:
            h = (h - POOL) // POOL_STRIDE + 1       # VALID
    return h, h, c_last


def param_layouts(plan) -> Dict[str, Layout]:
    """Each leaf's layout on the mesh: the conv stack and ``fc3_w``
    replicated, ``fc1_w`` column- and ``fc2_w`` row-split over the plan's
    tensor axis."""
    tp = plan.tp_axis
    out = {}
    for i in range(len(CONV_STAGES)):
        out[f"conv{i}_w"] = Layout.replicated(4)
        out[f"conv{i}_b"] = Layout((None,))
    out.update(fc1_w=Layout((None, tp)), fc2_w=Layout((tp, None)),
               fc3_w=Layout((None, None)))
    return out


def init(seed: int, plan, mesh, *, img_size: int = 224,
         n_classes: int = 1000, scale_down: int = 1,
         dtype: torch.dtype = torch.bfloat16,
         device="cuda") -> Params:
    """Random weights from ``seed`` (the conv stack, then the FC head at
    std 0.02, no biases), each leaf drawn whole; on a mesh (``mesh`` over
    a group), this rank's blocks."""
    specs = param_specs(plan, mesh, n_classes=n_classes,
                        scale_down=scale_down)
    meta = specs.pop("_meta")
    flat = math.prod(feature_shape(img_size, meta["c_last"]))
    fc, nc = meta["fc"], meta["n_classes"]
    lay = (param_layouts(plan) if plan is not None
           else {k: None for k in ("fc1_w", "fc2_w", "fc3_w")})
    specs.update(
        fc1_w=ParamSpec((flat, fc), dtype, layout=lay["fc1_w"]),
        fc2_w=ParamSpec((fc, fc), dtype, layout=lay["fc2_w"]),
        fc3_w=ParamSpec((fc, nc), dtype, layout=lay["fc3_w"]))
    return tree_init(seed, specs, torch.device(device),
                     mesh if mesh is not None and mesh.size > 1 else None)


# ---------------------------------------------------------------------------
# the conv stack
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_tf32():
    """cuDNN's TF32 off for the block, the previous setting restored after
    it (cuDNN itself stays on)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2d(torch.autograd.Function):
    """An fp32 NCHW convolution of a padded input, forward and backward
    with TF32 off (autograd runs the backward outside the forward's
    call)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _no_tf32():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, [ctx.stride] * 2, [0, 0],
                [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after), the smaller
    half before."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_stage(params: Params, i: int, x: torch.Tensor) -> torch.Tensor:
    """Stage ``i``'s convolution of NCHW ``x``: SAME-padded, in fp32 with
    TF32 off, before its bias."""
    _, k, s, _ = CONV_STAGES[i]
    top, bottom = same_pad(x.shape[2], k, s)
    left, right = same_pad(x.shape[3], k, s)
    xp = F.pad(x.float(), (left, right, top, bottom))
    w = params[f"conv{i}_w"].float().permute(3, 2, 0, 1).contiguous()
    return _Conv2d.apply(xp, w, s)


def _features(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Conv feature stack: NHWC images -> NHWC features in the weights'
    dtype (the convs in fp32 on NCHW views)."""
    x = x.permute(0, 3, 1, 2)
    for i, (_, _, _, pool) in enumerate(CONV_STAGES):
        y = conv_stage(params, i, x)
        b = params[f"conv{i}_b"].float()
        x = torch.relu(y + b[:, None, None]).to(params[f"conv{i}_w"].dtype)
        if pool:
            x = F.max_pool2d(x, POOL, POOL_STRIDE)
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the model-parallel head, the loss and its gradients
# ---------------------------------------------------------------------------

def _rows(images: torch.Tensor, plan, mesh) -> Tuple[torch.Tensor, tuple]:
    """This rank's rows of the global batch and the axes they split over
    (none on one rank, or when the rows do not split)."""
    if mesh is None or mesh.size == 1:
        return images, ()
    n = math.prod(mesh.shape[a] for a in plan.batch_axes)
    if n == 1 or images.shape[0] % n:
        return images, ()
    return batch_block(images, mesh, plan.batch_axes), tuple(plan.batch_axes)


def forward(params: Params, images: torch.Tensor, plan=None,
            policy: precision.Policy = precision.MIXED,
            mesh=None) -> torch.Tensor:
    """images (B, H, W, 3), the global batch -> logits (B, n_classes) in
    the accumulation dtype (on a mesh: this rank's rows of them).

    The flatten boundary is the DP->MP switchpoint: the features stay
    batch-split and the FC runs col->row model-parallel — dMath §4's
    hybrid scheme."""
    x, rows = _rows(images, plan, mesh)
    x = _features(params, x)
    x = x.reshape(x.shape[0], -1)
    tp = None
    if mesh is not None and mesh.size > 1:
        flat = Layout((rows or None, None))
        x = constrain(x, flat, mesh, src=flat)
        tp = plan.tp_axis if mesh.shape.get(plan.tp_axis, 1) > 1 else None
    if tp is not None:
        x = dist_mod.copy_ad(x, mesh, tp)
    h = precision.matmul(x, params["fc1_w"], policy=policy)
    h = torch.relu(h)
    h = precision.matmul(h.to(x.dtype), params["fc2_w"], policy=policy)
    if tp is not None:
        h = dist_mod.psum_ad(h, mesh, tp)
    h = torch.relu(h)
    return precision.matmul(h.to(x.dtype), params["fc3_w"], policy=policy)


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            plan=None, policy: precision.Policy = precision.MIXED,
            mesh=None) -> torch.Tensor:
    """The mean over the global batch of fp32 ``logsumexp - gold``.  On a
    mesh every rank returns the mean; its gradient is that of this rank's
    rows' share of it."""
    logits = forward(params, images, plan, policy, mesh).float()
    labels, rows = _rows(labels, plan, mesh)
    per = torch.logsumexp(logits, -1) - logits.gather(
        1, labels.long()[:, None])[:, 0]
    if not rows:
        return per.mean()
    share = precision.div_count(per.sum(), images.shape[0])
    return dist_mod.psum_ad(share, mesh, rows)


def value_and_grad(params: Params, images: torch.Tensor,
                   labels: torch.Tensor, plan=None,
                   policy: precision.Policy = precision.MIXED,
                   mesh=None) -> Tuple[torch.Tensor, Params]:
    """(loss, gradients) of :func:`loss_fn`, each gradient in its leaf's
    dtype; on a mesh each leaf's gradient summed over the batch axes (the
    rows' shares; every leaf is replicated there)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, images, labels, plan, policy, mesh)
    names = list(leaves)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names])))
    _, rows = _rows(images, plan, mesh)
    if rows:
        grads = {n: dist_mod.psum(g, mesh, rows) for n, g in grads.items()}
    return loss.detach(), grads


def wire_bytes(params: Params, batch: int, plan, mesh
               ) -> Dict[str, int]:
    """The bytes one rank receives in one :func:`value_and_grad` on the
    mesh, by collective, from the layouts (``params``: this rank's
    blocks; ``batch``: the global rows): fc2's fp32 partial sums and fc1's
    input gradient (bf16) over the model axis, the loss and every leaf's
    gradient over the batch axes.  An all-reduce over n ranks receives
    2 (n - 1) / n of its tensor at n <= 2, (n - 1) of it above
    (:func:`~repro_torch.core.distributed.psum`)."""
    def recv(nbytes: int, axes) -> int:
        out = 0
        for a in axes:
            n = mesh.shape[a]
            if n > 1:
                out += (n - 1) * nbytes if n > 2 else \
                    2 * (n - 1) * nbytes // n
        return out

    nb = math.prod(mesh.shape[a] for a in plan.batch_axes)
    rows = batch // nb if batch % nb == 0 else batch
    split = plan.batch_axes if batch % nb == 0 else ()
    tp = (plan.tp_axis,)
    fc = params["fc2_w"].shape[1]
    flat = params["fc1_w"].shape[0]
    act = params["fc1_w"].element_size()
    model = recv(rows * fc * 4, tp) + recv(rows * flat * act, tp)
    data = recv(4, split) + sum(recv(v.numel() * v.element_size(), split)
                                for v in params.values())
    return {"all_reduce": model + data}
