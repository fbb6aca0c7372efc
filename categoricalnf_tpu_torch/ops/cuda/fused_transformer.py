"""Wrappers of the fused SetTransformer kernels
(``csrc/fused_transformer.cu``): the forward (#3) and its backward (#4).

Counterparts of ``_fused_fwd`` and ``_fused_bwd`` in
``categoricalnf_tpu/ops/pallas/fused_transformer.py``.  The kernels' plain
version is the unfused path of ``networks.transformer.SetTransformer``
(``plain_forward``, and autograd through it), which every CPU tensor takes;
these wrappers take CUDA tensors only and raise on what the kernels do not
take.  ``PackedWeights`` checks and casts the weights once, so a launch does
neither.  ``FusedSetTransformer`` ties the two kernels together for
autograd, as ``defvjp`` does in the reference.  ``LAUNCHES`` and
``BWD_LAUNCHES`` count launches by compute dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from categoricalnf_tpu_torch.ops.cuda import build

# Must agree with csrc/fused_transformer.cu (kMaxSet, kTileTarget,
# kRowsPerThread) and the H100's 227 KB of shared memory per block.
MAX_SET = 32
TILE_TARGET = 32
ROWS_PER_THREAD = 8
MAX_SMEM = 232_448
# an H100 SM's shared memory, of which the runtime reserves 1 KB a block
SMEM_PER_SM = 233_472

NUM_W = 12
LAUNCHES = {"bfloat16": 0, "float32": 0}
BWD_LAUNCHES = {"bfloat16": 0, "float32": 0}

_ENTRY = {torch.bfloat16: ("fused_set_transformer_fwd_bf16", "bfloat16"),
          torch.float32: ("fused_set_transformer_fwd_f32", "float32")}
_BWD_ENTRY = {torch.bfloat16: "fused_set_transformer_bwd_bf16",
              torch.float32: "fused_set_transformer_bwd_f32"}


def flatten_params(net) -> tuple:
    """A SetTransformer's parameters as the reference's fixed 12-tuple:
    embed_w [IN,H], embed_b [1,H], qkv_w [L,H,3H], qkv_b [L,3H],
    proj_w [L,H,H], proj_b [L,H], fc1_w [L,H,RH], fc1_b [L,RH],
    fc2_w [L,RH,H], fc2_b [L,H], out_w [H,OUT], out_b [1,OUT]; all fp32."""
    def stack(key, part):
        return torch.stack([getattr(getattr(b, key), part)
                            for b in net.blocks])
    return (net.embed.w, net.embed.b[None, :],
            stack("qkv", "w"), stack("qkv", "b"),
            stack("proj", "w"), stack("proj", "b"),
            stack("fc1", "w"), stack("fc1", "b"),
            stack("fc2", "w"), stack("fc2", "b"),
            net.out.w, net.out.b[None, :])


def smem_bytes(set_size: int, in_dim: int, hidden: int, mlp: int) -> int:
    """Dynamic shared memory of one block, as the kernel computes it."""
    _, tile_pad = _tile(set_size)
    ld_big = max(3 * hidden, mlp, in_dim) + 1
    return 4 * tile_pad * (2 * (hidden + 1) + ld_big)


def _tile(set_size: int) -> tuple[int, int]:
    tile = max(1, TILE_TARGET // set_size) * set_size
    return tile, -(-tile // ROWS_PER_THREAD) * ROWS_PER_THREAD


def bwd_smem_bytes(set_size: int, in_dim: int, hidden: int, mlp: int,
                   out_dim: int, heads: int, layers: int) -> int:
    """Dynamic shared memory of one backward block, as the kernel computes
    it: the residual stream at each of the layers + 1 block boundaries,
    five [tile, H] buffers, qkv, a region for the MLP pair / the qkv
    gradient / g, and the softmax statistics."""
    _, tile_pad = _tile(set_size)
    ld_h, ld_big, ld_f = hidden + 1, 3 * hidden + 1, mlp + 1
    ld_r2 = max(2 * ld_f, ld_big, out_dim + 1, in_dim)
    return 4 * tile_pad * ((layers + 6) * ld_h + ld_big + ld_r2 + 3 * heads)


def bwd_grid(rows: int, set_size: int, smem: int, sms: int) -> int:
    """Persistent blocks of the backward: as many as fit on the card at
    once, never more than there are tiles."""
    tiles = -(-rows // _tile(set_size)[0])
    return max(1, min(tiles, sms * max(1, SMEM_PER_SM // (smem + 1024))))


def supported(x, cond, mask, hidden_dim: int, num_heads: int,
              mlp_ratio: int = 2) -> bool:
    """Whether the kernel covers this call: no cond or mask, x [B, S, IN]
    with S <= 32, heads dividing the width, and a tile that fits."""
    if cond is not None or mask is not None or x.dim() != 3:
        return False
    if hidden_dim % num_heads != 0 or not 1 <= x.shape[1] <= MAX_SET:
        return False
    return smem_bytes(x.shape[1], x.shape[2], hidden_dim,
                      mlp_ratio * hidden_dim) <= MAX_SMEM


def _lib():
    lib = build.load("fused_transformer")
    if not getattr(lib, "_cnf_typed", False):
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        for name, _ in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, l, i, i, i, i, i, i, i, p]
            fn.restype = i
        for name in _BWD_ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, p, p, l, i, i, i, i, i, i, i, i, p]
            fn.restype = i
        lib._cnf_typed = True
    return lib


class PackedWeights:
    """The 12-tuple ``ws`` (fp32, on the card) checked and made ready for
    the kernel once: the 6 matrices cast to the compute dtype, the 6 fp32
    biases contiguous, and their pointers; reused by every launch."""

    def __init__(self, ws, compute_dtype: torch.dtype):
        if compute_dtype not in _ENTRY:
            raise TypeError(f"fused SetTransformer: no kernel for "
                            f"{compute_dtype}")
        if len(ws) != NUM_W:
            raise ValueError(f"fused SetTransformer: {len(ws)} weights, "
                             f"want {NUM_W}")
        embed_w, qkv_w, fc1_w, out_w = ws[0], ws[2], ws[6], ws[10]
        self.in_dim, self.hidden = embed_w.shape
        self.layers, self.mlp = qkv_w.shape[0], fc1_w.shape[2]
        self.out_dim = out_w.shape[1]
        H, L, RH, OUT = self.hidden, self.layers, self.mlp, self.out_dim
        want = [(self.in_dim, H), (1, H), (L, H, 3 * H), (L, 3 * H),
                (L, H, H), (L, H), (L, H, RH), (L, RH), (L, RH, H), (L, H),
                (H, OUT), (1, OUT)]
        self.device = embed_w.device
        for j, (t, shape) in enumerate(zip(ws, want)):
            if tuple(t.shape) != shape:
                raise ValueError(f"fused SetTransformer: weight {j} has shape "
                                 f"{tuple(t.shape)}, want {shape}")
            if not t.is_cuda or t.device != self.device:
                raise ValueError("fused SetTransformer: weights must be CUDA "
                                 "tensors on one device")
            if t.dtype != torch.float32:
                raise TypeError("fused SetTransformer: weights must be fp32")
        if RH % H:
            raise ValueError(f"fused SetTransformer: MLP width {RH} is not a "
                             f"multiple of H={H}")
        self.dtype = compute_dtype
        self.shapes = tuple(tuple(t.shape) for t in ws)
        with torch.no_grad():
            self.mats = [ws[j].detach().to(compute_dtype).contiguous()
                         for j in (0, 2, 4, 6, 8, 10)]
            self.biases = [ws[j].detach().contiguous()
                           for j in (1, 3, 5, 7, 9, 11)]
        self.w_ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr()
                                              for t in self.mats))
        self.b_ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr()
                                              for t in self.biases))


def _check_x(packed: PackedWeights, x, num_heads: int, what: str):
    if not x.is_cuda or x.dim() != 3:
        raise ValueError(f"fused SetTransformer {what}: x must be a "
                         "[B, S, IN] CUDA tensor")
    if x.device != packed.device:
        raise ValueError(f"fused SetTransformer {what}: x on {x.device}, "
                         f"weights on {packed.device}")
    if (x.shape[2] != packed.in_dim
            or not supported(x, None, None, packed.hidden, num_heads,
                             packed.mlp // packed.hidden)):
        raise ValueError(f"fused SetTransformer {what}: unsupported call x "
                         f"{tuple(x.shape)}, H={packed.hidden}, "
                         f"heads={num_heads}")


def _forward_launch(packed: PackedWeights, x, num_heads: int):
    _check_x(packed, x, num_heads, "forward")
    B, S, in_dim = x.shape
    x2 = x.detach().to(packed.dtype).contiguous()
    y = torch.empty(B, S, packed.out_dim, dtype=packed.dtype, device=x.device)
    name, key = _ENTRY[packed.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), name)(
            x2.data_ptr(), packed.w_ptrs, packed.b_ptrs, y.data_ptr(), B * S,
            S, in_dim, packed.hidden, num_heads, packed.layers, packed.mlp,
            packed.out_dim, stream)
    build.check(err, name)
    LAUNCHES[key] += 1
    return y


def fused_set_transformer(packed: PackedWeights, x, *,
                          num_heads: int) -> torch.Tensor:
    """The whole SetTransformer on x [B, S, IN] (CUDA) from ``packed``;
    returns [B, S, OUT] in the packed compute dtype.  Not differentiable:
    with grad on and an ``x`` that needs one it raises, since the result
    would carry no graph (``FusedSetTransformer`` is the differentiable
    form)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_set_transformer drops the autograd graph: "
                           "use FusedSetTransformer.apply for training")
    return _forward_launch(packed, x, num_heads)


def fused_set_transformer_bwd(packed: PackedWeights, x, g, *,
                              num_heads: int):
    """Kernel #4: the cotangent ``g`` [B, S, OUT] of the net's output pulled
    back to x and the 12 weights.  Returns (dx in x's dtype, 12 fp32 weight
    gradients shaped as ``flatten_params``).  The matrices' gradients are
    rounded to the compute dtype, as the transpose of their cast."""
    _check_x(packed, x, num_heads, "backward")
    B, S, in_dim = x.shape
    if tuple(g.shape) != (B, S, packed.out_dim) or g.device != x.device:
        raise ValueError(f"fused SetTransformer backward: g "
                         f"{tuple(g.shape)} on {g.device}, want "
                         f"{(B, S, packed.out_dim)} on {x.device}")
    H, L, RH, OUT = packed.hidden, packed.layers, packed.mlp, packed.out_dim
    smem = bwd_smem_bytes(S, in_dim, H, RH, OUT, num_heads, L)
    if smem > MAX_SMEM:
        raise ValueError(f"fused SetTransformer backward: a tile needs "
                         f"{smem} bytes of shared memory, over {MAX_SMEM}")
    x2 = x.detach().to(packed.dtype).contiguous()
    g2 = g.detach().to(packed.dtype).contiguous()
    sizes = [math.prod(shape) for shape in packed.shapes]
    total = sum(sizes)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = bwd_grid(B * S, S, smem, sms)
    dx = torch.empty_like(x2)
    part = torch.empty(grid, total, dtype=torch.float32, device=x.device)
    dw = torch.empty(total, dtype=torch.float32, device=x.device)
    name = _BWD_ENTRY[packed.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), name)(
            x2.data_ptr(), g2.data_ptr(), packed.w_ptrs, packed.b_ptrs,
            dx.data_ptr(), part.data_ptr(), dw.data_ptr(), B * S, S, in_dim,
            H, num_heads, L, RH, OUT, grid, stream)
    build.check(err, name)
    BWD_LAUNCHES[_ENTRY[packed.dtype][1]] += 1
    dws = tuple(t.view(shape) for t, shape in
                zip(dw.split(sizes), packed.shapes))
    return dx.to(x.dtype), dws


class FusedSetTransformer(torch.autograd.Function):
    """``apply(x, packed, num_heads, *ws)``: the net's output from kernel #3,
    and from kernel #4 in backward dx (x's dtype) and the fp32 gradients of
    the 12-tuple ``ws`` (``flatten_params``, differentiable through its
    stacks).  ``packed`` holds ``ws`` cast once; only x is saved."""

    @staticmethod
    def forward(ctx, x, packed, num_heads, *ws):
        ctx.packed, ctx.num_heads = packed, num_heads
        ctx.save_for_backward(x)
        return _forward_launch(packed, x, num_heads)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx, dws = fused_set_transformer_bwd(ctx.packed, x, g,
                                            num_heads=ctx.num_heads)
        return (dx, None, None, *dws)
