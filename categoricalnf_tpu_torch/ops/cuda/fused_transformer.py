"""Wrapper of the fused SetTransformer forward kernel
(``csrc/fused_transformer.cu``).

Counterpart of ``_fused_fwd`` in
``categoricalnf_tpu/ops/pallas/fused_transformer.py``.  The kernel's plain
version is the unfused path of ``networks.transformer.SetTransformer``,
which every CPU tensor takes; this wrapper takes CUDA tensors only and
raises on what the kernel does not take.  ``PackedWeights`` checks and casts
the weights once, so a launch does neither.  ``LAUNCHES`` counts launches
by compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from categoricalnf_tpu_torch.ops.cuda import build

# Must agree with csrc/fused_transformer.cu (kMaxSet, kTileTarget,
# kRowsPerThread) and the H100's 227 KB of shared memory per block.
MAX_SET = 32
TILE_TARGET = 32
ROWS_PER_THREAD = 8
MAX_SMEM = 232_448

NUM_W = 12
LAUNCHES = {"bfloat16": 0, "float32": 0}

_ENTRY = {torch.bfloat16: ("fused_set_transformer_fwd_bf16", "bfloat16"),
          torch.float32: ("fused_set_transformer_fwd_f32", "float32")}


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
    tile = max(1, TILE_TARGET // set_size) * set_size
    tile_pad = -(-tile // ROWS_PER_THREAD) * ROWS_PER_THREAD
    ld_big = max(3 * hidden, mlp, in_dim) + 1
    return 4 * tile_pad * (2 * (hidden + 1) + ld_big)


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
        with torch.no_grad():
            self.mats = [ws[j].detach().to(compute_dtype).contiguous()
                         for j in (0, 2, 4, 6, 8, 10)]
            self.biases = [ws[j].detach().contiguous()
                           for j in (1, 3, 5, 7, 9, 11)]
        self.w_ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr()
                                              for t in self.mats))
        self.b_ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr()
                                              for t in self.biases))


def fused_set_transformer(packed: PackedWeights, x, *,
                          num_heads: int) -> torch.Tensor:
    """The whole SetTransformer on x [B, S, IN] (CUDA) from ``packed``;
    returns [B, S, OUT] in the packed compute dtype."""
    if not x.is_cuda or x.dim() != 3:
        raise ValueError("fused SetTransformer: x must be a [B, S, IN] "
                         "CUDA tensor")
    if x.device != packed.device:
        raise ValueError(f"fused SetTransformer: x on {x.device}, weights "
                         f"on {packed.device}")
    B, S, in_dim = x.shape
    if (in_dim != packed.in_dim
            or not supported(x, None, None, packed.hidden, num_heads,
                             packed.mlp // packed.hidden)):
        raise ValueError(f"fused SetTransformer: unsupported call x "
                         f"{tuple(x.shape)}, H={packed.hidden}, "
                         f"heads={num_heads}")
    x2 = x.to(packed.dtype).contiguous()
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
