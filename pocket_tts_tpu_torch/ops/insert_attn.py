"""K7: fused KV-row insert + T=1 decode attention over B lanes.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
decode_insert_attention` (`_decode_insert_attention_batched`). The CUDA
kernel is `csrc/insert_attn.cu` (its header says what bounds it on the
H100 and what the design does about it); the plain version writes the
rows with `index_copy_` and attends with the `sdpa_decode_seg` arithmetic
under a live-slot bias, lane by lane in one batched product.

`decode_insert_attention` runs the plain version for tensors on the CPU
and the kernel for tensors on the card; there is no other switch. Both
write the new rows into the caches IN PLACE (the JAX function returns new
caches through input/output aliasing).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF
from .basic import inv_sqrt


def insert_slot_bias(pos, cur_pos, read_end: int, write_slot: int):
    """(B, S) additive bias: slot s is attended iff s <= read_end and
    pos[b, s] >= 0, except the write slot, which is attended iff the new
    row is valid (cur_pos[b] >= 0) -- the kernel's mask."""
    idx = torch.arange(pos.shape[1], device=pos.device)
    ok = torch.where(idx == write_slot, (cur_pos >= 0)[:, None], pos >= 0)
    ok = ok & (idx <= read_end)
    return torch.where(ok, 0.0, NEG_INF).float()


def decode_insert_attention_plain(q, k_new, v_new, cur_pos, k_cache,
                                  v_cache, pos, read_end: int,
                                  write_slot: int):
    """q: (B, H, D); k_new/v_new: (B, 1, H*D) in the cache dtype; cur_pos:
    (B,) int32, the new row's position (-1: an invalid row); k/v_cache:
    (B, S, H*D) PRE-insert, written in place at `write_slot`; pos: (B, S)
    int32 POST-insert; read_end: last slot read (== write_slot in linear
    mode, S - 1 in ring mode). Returns (B, H, D)."""
    b, h, d = q.shape
    s = k_cache.shape[1]
    slot = torch.tensor([write_slot], device=k_cache.device)
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    bias = insert_slot_bias(pos, cur_pos, read_end, write_slot)
    logits = torch.einsum("bhd,bshd->bhs", q.float(),
                          k_cache.view(b, s, h, d).float()) * inv_sqrt(d)
    w = torch.softmax(logits + bias[:, None, :], -1)
    out = torch.einsum("bhs,bshd->bhd", w.to(v_cache.dtype).float(),
                       v_cache.view(b, s, h, d).float())
    return out.to(q.dtype)


def decode_insert_attention(q, k_new, v_new, cur_pos, k_cache, v_cache, pos,
                            read_end: int, write_slot: int):
    """Same contract as decode_insert_attention_plain; launches the CUDA
    kernel for CUDA tensors (float32 or bfloat16, D = 64, q and caches of
    one dtype), one launch for all B lanes."""
    if q.device.type == "cpu":
        return decode_insert_attention_plain(q, k_new, v_new, cur_pos,
                                             k_cache, v_cache, pos, read_end,
                                             write_slot)
    if q.device.type != "cuda":
        raise ValueError(f"decode_insert_attention: unsupported device "
                         f"{q.device}")
    b, h, d = q.shape
    s = k_cache.shape[1]
    hd = h * d
    ops = (q, k_new, v_new, k_cache, v_cache)
    if not (k_new.shape == v_new.shape == (b, 1, hd)
            and k_cache.shape == v_cache.shape == (b, s, hd)
            and pos.shape == (b, s) and cur_pos.shape == (b,)
            and pos.dtype == cur_pos.dtype == torch.int32
            and all(x.dtype == q.dtype for x in ops)
            and all(x.is_contiguous() and x.device == q.device
                    for x in ops + (pos, cur_pos))
            and 0 <= write_slot <= read_end < s):
        raise ValueError("decode_insert_attention: bad operands "
                         f"q{tuple(q.shape)} k{tuple(k_cache.shape)} "
                         f"pos{tuple(pos.shape)} read_end={read_end} "
                         f"write_slot={write_slot}")
    out = torch.empty_like(q)
    rc = cuda_lib.library().ptt_insert_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cur_pos.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, h, d, s, int(read_end), int(write_slot),
        cuda_lib.dtype_code(q), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_insert_attn")
    decode_insert_attention.launches += 1
    return out


decode_insert_attention.launches = 0
