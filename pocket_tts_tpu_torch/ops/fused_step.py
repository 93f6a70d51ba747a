"""K8: one whole quantized backbone layer at T = 1 in ONE launch (solo
decode with `backbone.use_megalayer`).

Replaces the TPU kernel `pocket_tts_tpu/ops/fused_step.py:_megalayer_call`
(entry point `megalayer`): LN1 + in_proj, rope and the K/V row's int8
quantization, K7's fused insert + flash decode, out_proj + residual + LN2 +
MLP + residual, with int8 or per-channel int4 weights and a cache of the
working type or int8 with per-row scales. The CUDA kernel is
`csrc/megalayer.cu` (its header says what bounds it on the H100 and what
the design does about it). The plain version `megalayer_plain` rounds where
the TPU kernel rounds (`fused_step.py:100-295`), which is not where the
3-call path (K5a + K7 + K5b) rounds:

  ln1  = round(LN(x))
  row  = ln1 @ W_in + b_in                                 float32
  q, k = round(rope(round(row_q))), round(rope(round(row_k)))
  v    = round(row_v)
  int8 cache: k, v quantized as models.backbone.quantize_rows does
  attn = round(attention over the cache's slots <= read_end with pos >= 0,
         the stale write slot left out, and the new row merged in float32
         from its (dequantized) values iff cur_pos >= 0)
  x1   = x + attn @ W_o + b_o                              float32
  h    = gelu(round(LN(x1)) @ W_1 + b_1): float32 at int4, rounded at int8
  y    = round(x1 + h @ W_2 + b_2)

(The TPU kernel's rope output passes through its scatter matmul in the
working type, so k is rounded after the rope as q is; in float32 every
rounding above is exact.) The softmax weights (times v_scale[s] for int8
rows) are rounded to the working type before the PV product, as K1 and K7
round them.

`megalayer` runs the plain version for tensors on the CPU and the kernel
for tensors on the card; there is no other switch, and a layer the kernel
does not take (`supported`: K-grouped q4_0 scales, as the JAX package's
`fused_step.supported` says) raises on either device. Both write the new
row's K/V bytes (and scales) into the caches IN PLACE at the write slot
(the JAX function returns new caches through input/output aliasing).
Launches count in `megalayer.launches` (int8 weights) or
`.launches_int4`, and with an int8 cache once more in `.launches_kv8`.

Under vmap the JAX package runs the 3-call path instead (its custom vmap
rule, `fused_step.py:579-587`); the port's lane path does the same
(models/backbone.forward_lanes).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib, fused_layer
from .attention import NEG_INF
from .basic import gelu, inv_sqrt, layer_norm, quantize_rows
from .quant_matmul import INT8, bits, grouped, kernel_operands
from .rope import apply_rope_halves

_LINEARS = ("in_proj", "out_proj", "linear1", "linear2")


def supported(p) -> bool:
    """The JAX package's `fused_step.supported`: a fused layer
    (fused_layer.supported) without K-grouped (q4_0) scales."""
    return fused_layer.supported(p) and not any(grouped(p[k])
                                                for k in _LINEARS)


def megalayer_plain(p, x, cos, sin, cur_pos, k_cache, v_cache, pos,
                    read_end: int, write_slot: int, k_scale=None,
                    v_scale=None, gelu_approx: bool = False,
                    eps: float = 1e-5):
    """p: one layer's params (supported(p)); x (1, dm); cos/sin (1, D/2)
    float32 rope tables of the new row's position; cur_pos (1,) int32 (< 0:
    an invalid row); k/v_cache (S, dm) PRE-insert, of x's dtype or int8
    with k_scale/v_scale (S,) float32; pos (S,) int32 POST-insert; read_end
    the last slot read, write_slot the new row's slot. Writes the new row
    (and its scales) at write_slot in place; returns y (1, dm)."""
    dt = x.dtype
    dm = x.shape[-1]
    d = 2 * cos.shape[-1]
    h = dm // d
    f = fused_layer._deq
    row = f(layer_norm(p["norm1"], x, eps=eps), p["in_proj"])
    rq, rk, rv = row.split(dm, -1)
    q = apply_rope_halves(rq.to(dt).reshape(1, h, d), cos, sin)[0]
    k = apply_rope_halves(rk.to(dt).reshape(1, h, d), cos, sin).reshape(1, dm)
    v = rv.to(dt)
    quant = k_scale is not None
    if quant:
        (kn, ks), (vn, vs) = quantize_rows(k), quantize_rows(v)
        knf, vnf = kn.float() * ks, vn.float() * vs
    else:
        kn, vn = k.to(k_cache.dtype), v.to(v_cache.dtype)
        knf, vnf = kn.float(), vn.float()
    s = k_cache.shape[0]
    scale = inv_sqrt(d)
    logits = torch.einsum("hd,shd->hs", q.float(),
                          k_cache.view(s, h, d).float()) * scale
    if quant:
        logits = logits * k_scale
    idx = torch.arange(s, device=x.device)
    ok = (pos >= 0) & (idx <= read_end) & (idx != write_slot)
    lnew = (q.float() * knf.view(h, d)).sum(-1) * scale
    ok_all = torch.cat([ok.expand(h, s), (cur_pos >= 0).expand(h, 1)], -1)
    w = torch.softmax(torch.cat([logits, lnew[:, None]], -1)
                      + torch.where(ok_all, 0.0, NEG_INF), -1)
    wo = w[:, :s] * (v_scale if quant else 1.0)
    attn = (torch.einsum("hs,shd->hd", wo.to(dt).float(),
                         v_cache.view(s, h, d).float())
            + w[:, s:] * vnf.view(h, d)).reshape(1, dm).to(dt)
    x1 = x.float() + f(attn, p["out_proj"])
    hmid = gelu(f(layer_norm(p["norm2"], x1, eps=eps).to(dt), p["linear1"]),
                gelu_approx)
    if bits(p["linear1"]) == 8:
        hmid = hmid.to(dt)
    y = (x1 + f(hmid, p["linear2"])).to(dt)
    k_cache[write_slot] = kn[0]
    v_cache[write_slot] = vn[0]
    if quant:
        k_scale[write_slot] = ks[0]
        v_scale[write_slot] = vs[0]
    return y


@functools.lru_cache(maxsize=None)
def _grid(dm: int, hid: int, quant: bool, code: int) -> int:
    """K8's cooperative grid: one block per 32-unit hidden tile (and at
    least as many as the in_proj's 32-column tiles), at most as many as the
    card holds at once (0 when the query fails)."""
    tiles = max(-(-hid // 32), -(-3 * dm // 32))
    return min(tiles, cuda_lib.library().ptt_megalayer_max_blocks(
        dm, int(quant), code))


def megalayer(p, x, cos, sin, cur_pos, k_cache, v_cache, pos, read_end: int,
              write_slot: int, k_scale=None, v_scale=None,
              gelu_approx: bool = False, eps: float = 1e-5):
    """Same contract as megalayer_plain; launches K8 once for CUDA tensors
    (x float32 or bfloat16, D = 64, supported(p); the caches of x's dtype,
    or int8 with float32 scales)."""
    if not supported(p):
        raise ValueError(
            "megalayer: takes int8 or per-channel int4 layers, not "
            f"{[bits(p[k]) for k in _LINEARS]} with grouped scales "
            f"{[grouped(p[k]) for k in _LINEARS]}")
    if x.device.type == "cpu":
        return megalayer_plain(p, x, cos, sin, cur_pos, k_cache, v_cache,
                               pos, read_end, write_slot, k_scale, v_scale,
                               gelu_approx, eps)
    if x.device.type != "cuda":
        raise ValueError(f"megalayer: unsupported device {x.device}")
    dm = x.shape[-1]
    s = k_cache.shape[0]
    d = 2 * cos.shape[-1]
    quant = k_scale is not None
    kv = torch.int8 if quant else x.dtype
    scales = (k_scale, v_scale) if quant else ()
    vecs = [(p["norm1"].get("scale"), dm), (p["norm1"].get("bias"), dm),
            (p["norm2"].get("scale"), dm), (p["norm2"].get("bias"), dm)]
    fused_layer._check("megalayer", p, x, vecs)
    if not (x.shape == (1, dm) and d == 64 and dm % d == 0
            and cos.shape == sin.shape == (1, d // 2)
            and cos.dtype == sin.dtype == torch.float32
            and cur_pos.shape == (1,) and cur_pos.dtype == torch.int32
            and k_cache.shape == v_cache.shape == (s, dm)
            and k_cache.dtype == v_cache.dtype == kv
            and pos.shape == (s,) and pos.dtype == torch.int32
            and all(t.shape == (s,) and t.dtype == torch.float32
                    for t in scales)
            and all(t.is_contiguous() and t.device == x.device
                    for t in (cos, sin, cur_pos, k_cache, v_cache, pos)
                    + scales)
            and 0 <= write_slot <= read_end < s):
        raise ValueError(
            f"megalayer: bad operands x{tuple(x.shape)} {x.dtype} cos"
            f"{tuple(cos.shape)} cache{tuple(k_cache.shape)} {k_cache.dtype}"
            f" pos{tuple(pos.shape)} read_end={read_end} "
            f"write_slot={write_slot}")
    hid = p["linear1"]["scale"].shape[-1]
    lins, kinds = [], []
    for name, k, n in (("in_proj", dm, 3 * dm), ("out_proj", dm, dm),
                       ("linear1", dm, hid), ("linear2", hid, dm)):
        tensors, (kind, _) = kernel_operands(p[name], k, n, x)
        lins.append(tensors)
        kinds.append(kind)
    code = cuda_lib.dtype_code(x)
    grid = _grid(dm, hid, quant, code)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = [torch.empty(3 * dm, **f32), torch.empty(dm, **f32),
               torch.empty(dm, **f32), torch.empty(grid, dm, **f32)]
    y = torch.empty_like(x)
    ptrs = ([x, p["norm1"].get("scale"), p["norm1"].get("bias"), *lins[0],
             cos, sin, cur_pos, k_cache, v_cache, pos,
             k_scale if quant else None, v_scale if quant else None,
             *lins[1], p["norm2"].get("scale"), p["norm2"].get("bias"),
             *lins[2], *lins[3]] + scratch + [y])
    rc = cuda_lib.library().ptt_megalayer(
        (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr()
                                        for t in ptrs]),
        (ctypes.c_int * 4)(*kinds), dm, hid, d, s, int(read_end),
        int(write_slot), float(eps), int(gelu_approx), grid, code,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_megalayer")
    if kinds[0] == INT8:
        megalayer.launches += 1
    else:
        megalayer.launches_int4 += 1
    if quant:
        megalayer.launches_kv8 += 1
    return y


megalayer.launches = megalayer.launches_int4 = megalayer.launches_kv8 = 0
