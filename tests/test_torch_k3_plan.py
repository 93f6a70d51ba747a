"""How K3 (csrc/seanet_frame.cu) cuts the SEANet decoder's frame into
launches, checked on the CPU:

- `k3_plan`: for every conv-GEMM of the decoder at 1 to 128 lanes, the
  output tiles cover the M x N outputs once and the reduction slices cover
  the K-tiles once, none empty, in clusters of at most 8 blocks; the final
  conv's blocks cover each lane's rows once; a frame is 14 launches,
  not more than the first port's 22;
- a plain model of the launch sequence (`frame_launches`: each GEMM's A
  operand built as the kernel builds it, the overlap-adds writing y, ELU(y)
  and their carries, the epilogues, the carries written by a later
  launch's tails, the final conv) equals the plain chain
  (`models/seanet.forward_plain`) over frames, pcm and all 8 carries: f32
  within 1e-5, bf16 within the card check's 5e-2 relative; and no launch
  writes a carry that another block of it reads.
"""
import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.config import DEFAULT_CONFIG, tiny_config
from pocket_tts_tpu_torch.io.params import random_params
from pocket_tts_tpu_torch.models import seanet
from pocket_tts_tpu_torch.ops.basic import elu
from pocket_tts_tpu_torch.ops.seanet_frame import (
    A_ROWS, A_WINDOW, BK, LAST_ROWS, MAX_SPLITS, TILES, WAVE,
    frame_launches, frame_shapes, k3_last_split, k3_plan, prep_weights)

SC = DEFAULT_CONFIG.mimi.seanet
TPF = DEFAULT_CONFIG.mimi.upsample_stride


def covered_once(total, step, parts):
    seen = np.zeros(total, dtype=int)
    for lo in range(0, parts * step, step):
        seen[lo: lo + step] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("b", [1, 2, 32, 64, 128])
def test_k3_plan_covers_each_gemm_once(b):
    launches = frame_shapes(SC, b, TPF)
    assert len(launches) == 14 <= 22
    assert [k for _, k, *_ in launches].count("overlap") == 3
    for name, kind, m, n, k in launches:
        if kind != "gemm":
            continue
        bm, bn, splits = k3_plan(m, n, k)
        assert (bm, bn) in TILES and 1 <= splits <= MAX_SPLITS
        # output tiles: ceil(M / BM) x ceil(N / BN), each output once
        assert covered_once(m, bm, -(-m // bm)) and bm * -(-m // bm) >= m
        assert covered_once(n, bn, -(-n // bn)) and bn * -(-n // bn) >= n
        # reduction slices of ceil(k-tiles / splits), none empty
        ktiles = -(-k // BK)
        per = -(-ktiles // splits)
        slices = [(z * per, min(ktiles, (z + 1) * per))
                  for z in range(splits)]
        assert all(lo < hi for lo, hi in slices), (name, slices)
        seen = np.zeros(ktiles, dtype=int)
        for lo, hi in slices:
            seen[lo:hi] += 1
        assert (seen == 1).all()
    name, kind, m, n, k = launches[-1]
    assert (name, kind, n) == ("model_11", "last", 1)
    # the final conv's blocks of LAST_ROWS rows cover each lane's rows once
    nt = m // b
    g = k3_last_split(nt)
    seen = np.zeros(nt, dtype=int)
    for i in range(g):
        seen[i * LAST_ROWS: min(nt, (i + 1) * LAST_ROWS)] += 1
    assert (seen == 1).all() and (g - 1) * LAST_ROWS < nt


def test_k3_plan_fills_the_card_solo_and_at_32_lanes():
    """Solo, the plan splits the long reductions over clusters and leaves
    the short ones whole; at 32 lanes every GEMM's grid reaches WAVE
    blocks."""
    solo = {name: k3_plan(m, n, k) for name, kind, m, n, k in
            frame_shapes(SC, 1, TPF) if kind == "gemm"}
    assert solo["model_0"][2] == MAX_SPLITS
    assert solo["model_9.block_3"][2] == 1
    for name, kind, m, n, k in frame_shapes(SC, 32, TPF):
        if kind == "gemm":
            bm, bn, splits = k3_plan(m, n, k)
            assert -(-m // bm) * -(-n // bn) * splits >= WAVE, name


# ------------------------------------------------------- launch model ---

def rnd(v, dt):
    return v.to(dt).float()


def emulate(launches, nb):
    """Run `frame_launches`' specs as the kernels compute them."""
    for name, kind, sp in launches:
        if kind == "last":
            h, dt = sp["h"], sp["out"].dtype
            nt, cin, kw, pc = sp["nt"], sp["cin"], sp["kw"], sp["pc"]
            car = sp["carry"].reshape(nb, pc, cin).float()
            xc = torch.cat([car[:, pc - kw + 1:], h.float().view(nb, nt, cin)],
                           1)
            acc = sum(xc[:, j: j + nt] @ sp["w"].float()[j * cin:
                                                          (j + 1) * cin]
                      for j in range(kw))
            b = 0.0 if sp["bias"] is None else sp["bias"].float()
            sp["out"].copy_(rnd(acc + b, dt).reshape(sp["out"].shape))
            sp["carry"].copy_(h.view(nb, nt, cin)[:, nt - pc:].reshape(
                sp["carry"].shape))
            continue
        if kind == "overlap":
            y, s, nu = sp["y"], sp["s"], sp["nu"]
            dt, c = y.dtype, y.shape[1]
            u = sp["u"].float().view(nb, nu, 2 * s * c)
            prev = torch.cat([sp["carry"].float().view(nb, 1, s * c),
                              u[:, :-1, s * c:]], 1)
            v = (u[..., : s * c] + prev).reshape(nb, nu * s, c)
            if sp["bias"] is not None:
                v = v + sp["bias"].float()
            v = rnd(v, dt)
            y.copy_(v.reshape(y.shape))
            sp["ye"].copy_(rnd(elu(v), dt).reshape(y.shape))
            sp["carry"].copy_(sp["u"].view(nb, nu, 2 * s * c)[:, -1, s * c:]
                              .reshape(sp["carry"].shape))
            continue
        out, dt = sp["out"], sp["out"].dtype
        reads = [sp[k] for k in ("src", "carry", "res") if sp[k] is not None]
        # the tail first: the kernel copies it beside the tiles, so it may
        # not write a tensor the launch reads
        if sp["tail"] is not None:
            src, dst, rows, tnt = sp["tail"]
            assert not any(dst.data_ptr() == r.data_ptr() for r in reads)
            w = src.shape[1]
            dst.copy_(src.view(nb, tnt, w)[:, tnt - rows:].reshape(dst.shape))
        cin, nt, kw, pc = sp["cin"], sp["nt"], sp["kw"], sp["pc"]
        if sp["mode"] == A_ROWS:
            a = sp["src"].float()
        else:
            assert sp["mode"] == A_WINDOW
            car = sp["carry"].reshape(nb, pc, cin).float()
            xc = torch.cat([car[:, pc - kw + 1:],
                            sp["src"].float().view(nb, nt, cin)], 1)
            a = torch.cat([xc[:, j: j + nt] for j in range(kw)], -1) \
                .reshape(nb * nt, kw * cin)
        y = a @ sp["w"].float()
        y = rnd(y + (0.0 if sp["bias"] is None else sp["bias"].float()), dt)
        if sp["out_elu"]:
            y = rnd(elu(y), dt)
        if sp["res"] is not None:
            y = rnd(sp["res"].float() + y, dt)
            if sp["res_elu"]:
                y = rnd(elu(y), dt)
        out.copy_(y)


def check_frames(cfg, nb, dtype, frames, tol):
    p, cfg = random_params(cfg)
    sc, tpf = cfg.mimi.seanet, cfg.mimi.upsample_stride
    dec = _cast(p["mimi"]["decoder"], dtype)
    weights = prep_weights(dec, sc)
    st_k = seanet.init_state(sc, tpf, dtype)
    if nb > 1:
        st_k = {k: v[None].repeat(nb, *([1] * v.dim())).contiguous()
                for k, v in st_k.items()}
    st_p = {k: v.clone() for k, v in st_k.items()}
    rng = np.random.RandomState(nb + frames)
    for f in range(frames):
        z = torch.from_numpy(rng.randn(nb, tpf, sc.in_ch).astype(np.float32)
                             ).to(dtype)
        launches, pcm = frame_launches(sc, st_k, z.reshape(nb * tpf, -1),
                                       weights, nb)
        # frame_shapes lists the same launches
        shapes = [(n, k, *(sp["out"].shape if k != "overlap" else
                           sp["y"].shape),
                   0 if k == "overlap" else sp["w"].shape[0])
                  for n, k, sp in launches]
        assert shapes == [tuple(r) for r in frame_shapes(sc, nb, tpf)]
        emulate(launches, nb)
        new, want = seanet.forward_plain(dec, sc, st_p, z if nb > 1 else z[0])
        for key in st_p:
            st_p[key].copy_(new[key])
        want = want.reshape(pcm.shape).float()
        scale = want.abs().max().item()
        assert (pcm.float() - want).abs().max().item() <= tol * scale, f
        for key in st_p:
            cs = max(st_p[key].float().abs().max().item(), 1e-30)
            err = (st_k[key].float() - st_p[key].float()).abs().max().item()
            assert err <= tol * cs, (f, key, err / cs)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("nb", [1, 3])
def test_k3_launch_model_equals_plain_tiny_f32(nb):
    check_frames(tiny_config(), nb, torch.float32, 4, 1e-5)


def test_k3_launch_model_equals_plain_wide_f32():
    """Channels of a whole number of 16-byte vectors, two lanes."""
    cfg = tiny_config(64)
    check_frames(cfg, 2, torch.float32, 3, 1e-5)


def test_k3_launch_model_bf16_within_card_tolerance():
    """The kernels round where the TPU kernel rounds, the plain chain where
    XLA's does: bf16 stays within chip_smoke.py's 5e-2 relative."""
    check_frames(tiny_config(64), 2, torch.bfloat16, 3, 5e-2)
