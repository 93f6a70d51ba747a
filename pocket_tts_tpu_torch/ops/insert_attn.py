"""K7: fused KV-row insert + T=1 decode attention over B lanes.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
decode_insert_attention` (`_decode_insert_attention_batched`), with caches
of the working type or int8 caches with per-row float32 scales (`quant`),
and optionally returning the flash statistics (`stats`) that the
shared-prefix serving merges with the prompt partial
(ops/attention.merge_attn_partials). The CUDA kernel is
`csrc/insert_attn.cu` (its header says what bounds it on the H100 and what
the design does about it); the plain version writes the rows with
`index_copy_` and attends with the kernel's arithmetic, lane by lane in one
batched product:

- working-type caches: the write slot is attended from the row just
  written (cur_pos >= 0), like every other live slot; the softmax weights
  are rounded to the cache type before the PV product.
- int8 caches: the new row arrives quantized (`models.backbone.
  quantize_rows`) with its (B,) scales; its bytes and scales go to the
  write slot, and the slot is attended from the new row times its scale
  in float32, unrounded, as the TPU kernel merges it after its block loop;
  the other slots' logits are (q . k) * scale * k_scale[s] and their
  softmax weights times v_scale[s] are rounded to the working type.
- stats: m (B, H), the post-merge running max, and l (B, H), the
  normaliser. A slot that is masked is skipped (the TPU kernel adds a
  finite -1e9): a lane with no attended slot gives out 0, m = -inf and
  l = 0, which merge_attn_partials turns into the other partial alone, as
  it does the TPU kernel's (-1e9, count) pair.

The kernel splits the slots [0, read_end] into `k7_split(read_end, S, B)`
chunks, one thread block each, merged on chip (one thread-block cluster
per head and lane; ops/decode_attn.chunk_units deals the slots out). The
kernel adapts to the cache's slot count S, and to nothing else:

- S <= K7_LONG_SLOTS (2,048; Pocket TTS's 1,024-slot caches): each block
  walks every slot of its chunk, a masked one zero-filled; with many
  lanes the card is full already, so the split takes at most
  K7_LANES_SPLITS (2) chunks (52 us at B = 32, S = 1,024 in the ring;
  33.5 over int8 caches at S = 896; chip_smoke.py on an H100 80GB HBM3
  at 700 W, csrc/insert_attn.cu has the rest).
- S > K7_LONG_SLOTS (Moshi's 3,072-slot ring, whose lanes hold a few
  hundred to 2,250 positions): each block first lists its chunk's
  attended slots (pos >= 0, the write slot as below) in increasing order
  and walks only those, so a call's time follows the rows its lanes
  hold; the split takes up to MAX_SPLITS (8) chunks at any lane count,
  so a lane's rows spread over its whole cluster. At D = 128, 32 heads,
  B = 32, lanes at ages of mean 646: 148.5 us, where walking every slot
  on 2 chunks took 291.7 (bound 101.7; the same card); at the duplex32
  cell's planned ages (mean 502) 118.6 (bound 79.2). Such launches count
  once more in `.launches_long`.

A lane's result depends only on its own inputs either way: the split and
the walk change only the order in which its slots are summed.

`decode_insert_attention` runs the plain version for tensors on the CPU
and the kernel for tensors on the card; there is no other switch. Both
write the new rows (and scales) into the caches IN PLACE (the JAX function
returns new caches through input/output aliasing). A launch counts once by
its caches, in `.launches` (working type) or `.launches_kv8` (int8), and,
when it returns the statistics, once more in `.launches_stats`.

The write slot is a host int, or the batch's slot cursor
(`models.frame_graph.Cursor`) when the lane frame runs from CUDA graphs:
the kernel then loads the slot from the cursor's int32 on the device at
block entry, and the plain version indexes with it, so a frame replayed
from a graph writes where the frame advanced the cursor; `int()` of it,
the host mirror, is what the checks here read. `read_end` and the split
stay host ints (fixed in ring mode: S - 1).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF
from .basic import inv_sqrt
from .decode_attn import MAX_SPLITS

# K7 deals the live slots out in units of K7_UNIT (csrc/insert_attn.cu)
# to chunks of at least K7_CHUNK slots, at most MAX_SPLITS (a cluster) and
# at most K7_LANES_SPLITS from K7_MANY_LANES lanes on. chip_smoke.py's
# `time_splits` times every count: solo, more chunks are faster up to 8;
# at 32 lanes (16 heads each, the card full) two chunks ran fastest, bf16
# and int8 (PERF.md, section 6). A cache of more than K7_LONG_SLOTS slots
# takes the long-ring walk (only the attended slots, compacted per chunk)
# and up to MAX_SPLITS chunks at any lane count: the wrapper decides and
# tells the kernel (its `long_ring` argument), so the threshold lives here.
K7_UNIT = 8
K7_CHUNK = 32
K7_MANY_LANES = 8
K7_LANES_SPLITS = 2
K7_LONG_SLOTS = 2048


def k7_split(read_end: int, s: int, b: int) -> int:
    """The number of chunks K7 cuts the slots [0, read_end] of an S-slot
    cache into at B lanes: one per K7_CHUNK slots, at most MAX_SPLITS, and,
    for a cache of at most K7_LONG_SLOTS slots, at most K7_LANES_SPLITS
    from K7_MANY_LANES lanes on."""
    if not 0 <= read_end < s:
        raise ValueError(f"k7_split: read_end {read_end} outside [0, {s})")
    n = min(MAX_SPLITS, -(-(read_end + 1) // K7_CHUNK))
    if s > K7_LONG_SLOTS or b < K7_MANY_LANES:
        return n
    return min(n, K7_LANES_SPLITS)


def insert_slot_mask(pos, cur_pos, read_end: int, write_slot: int,
                     quant: bool = False):
    """(B, S) bool: slot s is attended iff s <= read_end and pos[b, s] >= 0,
    except the write slot, which is attended iff the new row is valid
    (cur_pos[b] >= 0) -- and with int8 caches never from the cache (the
    new row is merged apart)."""
    idx = torch.arange(pos.shape[1], device=pos.device)
    new_ok = ((cur_pos >= 0) & (not quant))[:, None]
    ok = torch.where(idx == write_slot, new_ok, pos >= 0)
    return ok & (idx <= read_end)


def decode_insert_attention_plain(q, k_new, v_new, cur_pos, k_cache,
                                  v_cache, pos, read_end: int,
                                  write_slot: int, k_scale=None, v_scale=None,
                                  ks_new=None, vs_new=None,
                                  stats: bool = False):
    """q: (B, H, D); k_new/v_new: (B, 1, H*D) in the cache dtype; cur_pos:
    (B,) int32, the new row's position (-1: an invalid row); k/v_cache:
    (B, S, H*D) PRE-insert, written in place at `write_slot`; pos: (B, S)
    int32 POST-insert; read_end: last slot read (== write_slot in linear
    mode, S - 1 in ring mode). int8 caches: k_scale/v_scale (B, S) float32
    written in place at the write slot, ks_new/vs_new (B,) float32. Returns
    out (B, H, D) in q's dtype, and with stats (out, m, l), m and l (B, H)
    float32."""
    b, h, d = q.shape
    s = k_cache.shape[1]
    quant = k_scale is not None
    write_slot = cuda_lib.cursor_value(write_slot)
    slot = (write_slot.long() if isinstance(write_slot, torch.Tensor)
            else torch.tensor([write_slot], device=k_cache.device))
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    if quant:
        k_scale.index_copy_(1, slot, ks_new[:, None])
        v_scale.index_copy_(1, slot, vs_new[:, None])
    scale = inv_sqrt(d)
    logits = torch.einsum("bhd,bshd->bhs", q.float(),
                          k_cache.view(b, s, h, d).float()) * scale
    if quant:
        logits = logits * k_scale[:, None, :]
    ok = insert_slot_mask(pos, cur_pos, read_end, write_slot, quant)
    ok = ok[:, None, :].expand(b, h, s)
    if quant:
        knf = k_new[:, 0].float() * ks_new[:, None]
        vnf = v_new[:, 0].float() * vs_new[:, None]
        lnew = (q.float() * knf.view(b, h, d)).sum(-1) * scale
        logits = torch.cat([logits, lnew[..., None]], -1)
        ok = torch.cat([ok, (cur_pos >= 0)[:, None, None].expand(b, h, 1)],
                       -1)
    # a lane that attends no slot gets weights 0 (out 0), as the kernel
    w = (torch.softmax(logits + torch.where(ok, 0.0, NEG_INF), -1)
         * ok.any(-1, keepdim=True))
    if quant:
        pv = (w[..., :s] * v_scale[:, None, :]).to(q.dtype).float()
        out = (torch.einsum("bhs,bshd->bhd", pv,
                            v_cache.view(b, s, h, d).float())
               + w[..., s:] * vnf.view(b, h, d))
    else:
        out = torch.einsum("bhs,bshd->bhd", w.to(v_cache.dtype).float(),
                           v_cache.view(b, s, h, d).float())
    out = out.to(q.dtype)
    if not stats:
        return out
    masked = logits.masked_fill(~ok, float("-inf"))
    m = masked.amax(-1)
    l = torch.exp(masked - torch.where(torch.isfinite(m), m, 0.0)[..., None]
                  ).sum(-1)
    return out, m, l


@cuda_lib.entry
def decode_insert_attention(q, k_new, v_new, cur_pos, k_cache, v_cache, pos,
                            read_end: int, write_slot, k_scale=None,
                            v_scale=None, ks_new=None, vs_new=None,
                            stats: bool = False, out=None):
    """Same contract as decode_insert_attention_plain; launches the CUDA
    kernel for CUDA tensors (q float32 or bfloat16, D = 64; caches of q's
    dtype, or int8 with float32 scale rows; caches and new rows 16-byte
    aligned), one launch for all B lanes. write_slot: an int or a device
    cursor (module docstring). out: an earlier call's result (out, or
    (out, m, l) with stats), written again."""
    if q.device.type == "cpu":
        return cuda_lib.into(out, decode_insert_attention_plain(
            q, k_new, v_new, cur_pos, k_cache, v_cache, pos, read_end,
            write_slot, k_scale, v_scale, ks_new, vs_new, stats))
    if q.device.type != "cuda":
        raise ValueError(f"decode_insert_attention: unsupported device "
                         f"{q.device}")
    b, h, d = q.shape
    s = k_cache.shape[1]
    hd = h * d
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else q.dtype
    scales = (k_scale, v_scale, ks_new, vs_new) if quant else ()
    ops = (q, k_new, v_new, k_cache, v_cache)
    if not (k_new.shape == v_new.shape == (b, 1, hd)
            and k_cache.shape == v_cache.shape == (b, s, hd)
            and pos.shape == (b, s) and cur_pos.shape == (b,)
            and pos.dtype == cur_pos.dtype == torch.int32
            and all(x.dtype == kv_dtype for x in ops[1:])
            and all(x.dtype == torch.float32 for x in scales)
            and (not quant or (k_scale.shape == v_scale.shape == (b, s)
                               and ks_new.shape == vs_new.shape == (b,)))
            and all(x.is_contiguous() and x.device == q.device
                    for x in ops + (pos, cur_pos) + scales)
            and all(x.data_ptr() % 16 == 0 for x in ops[1:])
            and 0 <= int(write_slot) <= read_end < s):
        raise ValueError("decode_insert_attention: bad operands "
                         f"q{tuple(q.shape)} {q.dtype} k{tuple(k_cache.shape)}"
                         f" {k_cache.dtype} pos{tuple(pos.shape)} "
                         f"read_end={read_end} write_slot={write_slot}")
    if out is None:
        res = torch.empty_like(q)
        st = (torch.empty(2, b, h, dtype=torch.float32, device=q.device)
              if stats else None)
    elif stats:
        # (out, m, l): m and l are rows 0 and 1 of one (2, B, H) buffer
        res, st = out[0], out[1]
        if out[2].data_ptr() != st.data_ptr() + 4 * b * h:
            raise ValueError("decode_insert_attention: out is not a "
                             "result of this entry")
    else:
        res, st = out, None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = cuda_lib.library().ptt_insert_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cur_pos.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        ptr(k_scale), ptr(v_scale), ptr(ks_new), ptr(vs_new),
        res.data_ptr(), ptr(st), cuda_lib.cursor_ptr(write_slot), b, h, d, s,
        int(read_end), int(write_slot), k7_split(int(read_end), s, b),
        int(s > K7_LONG_SLOTS), cuda_lib.dtype_code(q),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_insert_attn")
    if quant:
        decode_insert_attention.launches_kv8 += 1
    else:
        decode_insert_attention.launches += 1
    if s > K7_LONG_SLOTS:
        decode_insert_attention.launches_long += 1
    if stats:
        decode_insert_attention.launches_stats += 1
        return out if out is not None else (res, st[0], st[1])
    return res


decode_insert_attention.launches = 0
decode_insert_attention.launches_kv8 = 0
decode_insert_attention.launches_stats = 0
decode_insert_attention.launches_long = 0
