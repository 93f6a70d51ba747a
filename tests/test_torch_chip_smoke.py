"""chip_smoke.py (the port's check on the card) fails when any phase
fails: its `main` catches exceptions in one place only, the final handler
that names the phase and returns 1, so no measurement or check can fail
while the run still exits 0 (a failing serving phase included). And
without a CUDA device it exits 1 and prints no result."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _main():
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def test_main_catches_only_in_its_final_handler():
    main = _main()
    handlers = [n for n in ast.walk(main) if isinstance(n, ast.ExceptHandler)]
    assert len(handlers) == 1, [h.lineno for h in handlers]
    (handler,) = handlers
    last = handler.body[-1]
    assert isinstance(last, ast.Return)
    assert isinstance(last.value, ast.Constant) and last.value.value == 1
    # the handler belongs to the last try statement of main's body
    tries = [n for n in main.body if isinstance(n, ast.Try)]
    assert tries and handler in tries[-1].handlers


def test_without_cuda_exits_1_and_prints_no_result():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert '"ok"' not in res.stdout and "kernels" not in res.stdout


SERVING = {"serve_vs_solo": "serving", "serve_throughput": "serving",
           "serve_cli": "serving: cli", "profile_serving": "profiler, serving"}
# phase 9: each step of the command line phase and the phase it names
COMMAND_LINE = {"cli_bench": "command line: --bench",
                "stream_rows": "command line: stream loop",
                "roofline_rows": "command line: roofline",
                "cli_profile": "command line: --profile",
                "cli_batch": "command line: --batch",
                "check_exact": "command line: --reference-exact",
                "check_ab": "command line: ab",
                "wide_chunk_walls": "command line: 128 lanes"}


def _run_with_one_failing(failing, monkeypatch, capsys):
    """main() with every phase stubbed to pass but `failing`, which
    raises: it returns 1, names the phase and prints no result. Returns
    the captured output."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.ops import cuda_lib

    class Engine:
        cfg = DEFAULT_CONFIG
        params = {"mimi": {"decoder": None}}
        seanet_weights = None

    def boom(*a, **k):
        raise RuntimeError(f"{failing} failed")

    stubs = dict(
        nvidia_smi=lambda: "card, 700 W", make_engine=lambda *a, **k: Engine(),
        counted_frame_steps=lambda: {}, counted_lane_steps=lambda: {},
        end_to_end=lambda *a, **k: ({}, 1, np.ones(4)),
        first_frames=lambda *a, **k: np.ones((12, 4)),
        time_decode=lambda bf, voice: {k: {"sync": [1.0], "nosync": [1.0]}
                                       for k in bf},
        time_kernels=lambda *a: {},
        profile_frames=lambda *a, **k: (1.0, [], {}),
        serve_vs_solo=lambda *a, **k: None,
        serve_throughput=lambda *a, **k: ({}, 0, {}),
        profile_serving=lambda *a, **k: (1.0, [2.0], 160, [], {}),
        serve_cli=lambda *a: None)
    for name in ("check_k1", "check_k2", "check_k3", "check_k7",
                 "check_k2_lanes", "check_k3_lanes", "check_quant_kernels",
                 "check_cache", "time_quant_kernels", "check_k1_kv8",
                 "check_k7_kv8", "check_quant_lanes", "time_kv8_kernels",
                 "time_lane_kernels", "check_k8", "check_k5c", "check_k2q",
                 "check_k1_lanes", "time_slice6_kernels",
                 "check_frame_launches", "check_quant_narrow",
                 "check_conv_kernels", "check_gguf", *COMMAND_LINE):
        stubs[name] = lambda *a, **k: None
    stubs["time_splits"] = lambda *a, **k: {}
    stubs["time_rows_plans"] = lambda *a, **k: []
    stubs["time_k4a_plans"] = lambda *a, **k: []
    stubs["k4a_marks"] = lambda *a, **k: {}
    stubs["time_flow_clusters"] = lambda *a, **k: {}
    stubs["time_conv_kernels"] = lambda *a, **k: {}
    stubs[failing] = boom
    for name, fn in stubs.items():
        monkeypatch.setattr(cs, name, fn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cuda_lib, "library", lambda: None)
    monkeypatch.setattr(cuda_lib, "build_seconds", lambda: 0.0)
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert not any(line.startswith('{"kernels"')
                   for line in out.out.splitlines())
    return out


@pytest.mark.parametrize("failing", sorted(SERVING))
def test_failing_serving_phase_fails_the_run(failing, monkeypatch, capsys):
    """Every other phase is stubbed to pass; the serving step that raises
    (or the serving profiler) makes main return 1, name its phase and
    print no result."""
    out = _run_with_one_failing(failing, monkeypatch, capsys)
    assert f"FAILED in phase '{SERVING[failing]}'" in out.err


@pytest.mark.parametrize("failing", sorted(COMMAND_LINE))
def test_failing_command_line_phase_fails_the_run(failing, monkeypatch,
                                                  capsys):
    """Phase 9 ([9] command line): each of its steps that raises makes
    main return 1, name its phase and print no result."""
    out = _run_with_one_failing(failing, monkeypatch, capsys)
    assert f"FAILED in phase '{COMMAND_LINE[failing]}'" in out.err
    assert "[9] command line" in out.out


def test_expected_exact_launches():
    """The reference-exact paths, from the JAX routing: no K1, K2, K7, K8
    or K5 launch, one K3 sequence a frame; with int8 weights K4a on every
    linear (1 + 6 x 4 backbone + 2 x 4 mimi a frame, 24 a prefill call)
    and K6's two launches."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    cfg = cs.path_cfg(DEFAULT_CONFIG, "exact")
    assert cs.expected_launches(cfg, "exact") == ({"seanet_frame": 1}, {})
    assert cs.expected_launches(cs.path_cfg(DEFAULT_CONFIG, "int8_exact"),
                                "int8_exact") == (
        {"seanet_frame": 1, "int8_matmul": 33, "fused_flow": 2},
        {"int8_matmul": 24})
    with pytest.raises(ValueError, match="not a reference-exact cfg"):
        cs.expected_launches(DEFAULT_CONFIG, "exact")


def test_every_kernel_entry_has_a_counter_source_and_tpu_site():
    """Each KERNELS entry (the serving mode's int8-KV, statistics and lane
    entries included) names a launch counter, a CUDA source of the port and
    the `pallas_call` line of the TPU kernel it replaces; the serving runs'
    entries are entries."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    counters = cs._counters()
    for name, entry in cs.KERNELS.items():
        fn, attr = counters[name]
        assert isinstance(getattr(fn, attr), int), name
        assert os.path.exists(os.path.join(ROOT, entry["source"])), name
        path, line = entry["replaces"].rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            assert "pallas_call" in f.read().splitlines()[int(line) - 1], name
    assert set(cs.SERVING_KV8_KERNELS) <= set(cs.KERNELS)
    assert len({(fn, attr) for fn, attr in counters.values()}) == len(
        counters)


def test_expected_serving_launches_per_step():
    """The serving mode at 32 lanes of DEFAULT_CONFIG: per batch frame step
    6 K7 (int8, with statistics), 2 K2, 1 K3, 2 K6 launches over the lanes
    (the modulations, then the chain), 8 K5a and (6 + 2) x 3 = 24 K5b
    launches, all 32 of them on the tensor cores (rows_mma), 1 K4b; 24 K4b
    per prefill."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    want = cs.expected_serving(DEFAULT_CONFIG, "int4_kv8", 1, 0)
    assert want == {"ring_attn": 2, "seanet_frame": 1,
                    "decode_insert_attn_kv8": 6,
                    "decode_insert_attn_stats": 6, "fused_pre_lanes": 8,
                    "fused_flow_lanes": 2, "fused_post_lanes": 24,
                    "rows_mma": 32, "int4_matmul": 1}
    assert cs.expected_serving(DEFAULT_CONFIG, "int4_kv8", 0, 2)[
        "int4_matmul"] == 48
    assert cs.expected_serving(DEFAULT_CONFIG, "bf16", 3, 1) == {
        "ring_attn": 6, "seanet_frame": 3, "decode_insert_attn": 18}


SLICE6 = {
    "megalayer": ("megalayer.cu", "pocket_tts_tpu/ops/fused_step.py:454"),
    "megalayer_int4": ("megalayer.cu",
                       "pocket_tts_tpu/ops/fused_step.py:454"),
    "megalayer_kv8": ("megalayer.cu",
                      "pocket_tts_tpu/ops/fused_step.py:454"),
    "bilayer": ("fused_layer.cu", "pocket_tts_tpu/ops/fused_layer.py:750"),
    "ring_attn_kv8": ("ring_attn.cu", "pocket_tts_tpu/ops/pallas_mimi.py:324"),
    "decode_attn_lanes": ("decode_attn.cu",
                          "pocket_tts_tpu/ops/pallas_attn.py:332"),
    "decode_attn_stats": ("decode_attn.cu",
                          "pocket_tts_tpu/ops/pallas_attn.py:332"),
}


@pytest.mark.parametrize("name", sorted(SLICE6))
def test_slice6_kernel_entries(name):
    """Slice 6's kernels (K8 and its int4 / int8-KV variants, K5c, K2-q, K1
    over lanes with and without statistics) are entries of the kernels
    line, each with its CUDA source, the TPU site it replaces, and a
    path whose run reports its launches."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    source, site = SLICE6[name]
    assert cs.KERNELS[name] == dict(
        source="pocket_tts_tpu_torch/csrc/" + source, replaces=site)
    assert name in cs.MEGA_KERNELS or name in cs.expected_serving(
        DEFAULT_CONFIG, cs.K1_SERVE, 1, 0, lanes=4)


def test_expected_launches_of_the_slice6_paths():
    """Per decoded frame at DEFAULT_CONFIG: int8 + megalayer 6 K8, 2 K5a, 2
    K5b (the mimi layers), 2 K2, no K1; int4 + int8 KV + megalayer + int8
    mimi ring the same with K8's int4 and int8-KV counts and K2-q; int4 +
    bilayer 1 + 2 K5a, 5 K5c, 1 + 2 K5b, 6 K1. K6 is 2 launches (the
    modulations, then the chain); the mimi layers' K5a (16 rows) run on the
    tensor cores (2 rows_mma launches a frame). Serving without the fused
    insert, per batch frame step: 6 K1 over lanes with statistics, 2 K2-q,
    no K7."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG

    def frame(path):
        return cs.expected_launches(cs.path_cfg(DEFAULT_CONFIG, path),
                                    path)[0]

    assert frame("int8_mega") == {
        "megalayer": 6, "fused_pre": 2, "fused_post": 2, "ring_attn": 2,
        "fused_flow": 2, "int8_matmul": 1, "seanet_frame": 1, "rows_mma": 2}
    assert frame("int4_kv8_mega") == {
        "megalayer_int4": 6, "megalayer_kv8": 6, "fused_pre_int4": 2,
        "fused_post_int4": 2, "ring_attn_kv8": 2, "fused_flow_int4": 2,
        "int4_matmul": 1, "seanet_frame": 1, "rows_mma": 2}
    assert frame("int4_bilayer") == {
        "fused_pre_int4": 3, "bilayer": 5, "fused_post_int4": 3,
        "decode_attn": 6, "ring_attn": 2, "seanet_frame": 1,
        "fused_flow_int4": 2, "int4_matmul": 1, "rows_mma": 2,
        "rows_skinny": 1}
    want = cs.expected_serving(cs.path_cfg(DEFAULT_CONFIG, cs.K1_SERVE),
                               cs.K1_SERVE, 1, 0, lanes=4)
    assert (want["decode_attn_lanes"], want["decode_attn_stats"],
            want["ring_attn_kv8"]) == (6, 6, 2)
    assert not any(k.startswith("decode_insert") for k in want)


def test_expected_launches_of_the_3_call_paths():
    """Per decoded frame on the int8, int4 and q4_0 paths: the backbone's
    six K5a at T = 1 on the skinny kernel (rows_skinny), the mimi layers'
    two on the tensor cores (rows_mma); K4a / K4b once (input_linear) and
    24 times a prefill call, K4a's 24 on the warpgroup kernel in a prefill
    call of 64 rows or more (int8_matmul_wgmma, a WIDE_PREFILL entry)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    for path in cs.QUANT_PATHS + (cs.KV8_PATH,):
        frame, prefill = cs.expected_launches(DEFAULT_CONFIG, path)
        mm, pre, post, flow = cs.PATH_KERNELS[
            cs.ENGINE_KW[path]["quantize"]]
        assert (frame["rows_skinny"], frame["rows_mma"], frame[pre],
                frame[post], frame[mm], frame[flow]) == (6, 2, 8, 8, 1, 2)
        assert prefill == ({mm: 24, "int8_matmul_wgmma": 24} if mm ==
                           "int8_matmul" else {mm: 24})
    assert cs.WIDE_PREFILL == ("int8_matmul_wgmma",)


# a frame of the int8 path as the profiler names its kernels: (kernel,
# us, launches per frame)
FRAME_KERNELS = [
    ("void ptt::decode_attn_kernel<__nv_bfloat16>(ptt::K1Args)", 5.6, 6.0),
    ("void ptt::ring_attn_kernel<__nv_bfloat16>(ptt::K2Args)", 9.0, 2.0),
    ("void ptt::seanet_gemm_kernel<__nv_bfloat16>(ptt::K3Args)", 50., 10.),
    ("void ptt::seanet_overlap_kernel<__nv_bfloat16>(ptt::K3Args)", 9., 3.),
    ("void ptt::seanet_last_kernel<__nv_bfloat16>(ptt::K3Args)", 5., 1.),
    ("ptt::skinny_kernel(ptt::SkinnyArgs)", 5.0, 7.0),
    ("void ptt::rows_mma_kernel<16>(ptt::RowsMmaArgs)", 9.5, 2.0),
    ("void ptt::fused_post_kernel<__nv_bfloat16>(ptt::PostArgs)", 18., 8.),
    ("ptt::flow_mods_kernel(ptt::FlowArgs)", 20.0, 1.0),
    ("ptt::flow_chain_kernel(ptt::FlowArgs)", 70.0, 1.0),
    ("void at::native::elementwise_kernel<...>", 1.0, 200.0)]
# the wrappers' counters over the same frames, per frame
FRAME_COUNTS = {"decode_attn": 6.0, "ring_attn": 2.0, "seanet_frame": 1.0,
                "int8_matmul": 1.0, "fused_pre": 8.0, "fused_post": 8.0,
                "fused_flow": 2.0, "rows_mma": 2.0, "rows_skinny": 6.0}


def test_frame_launch_check_agrees_with_the_counters():
    """The profiler's records and the launch counters over the same frames
    agree family by family; the check passes and logs that they agree."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    rows, verdict = cs.launch_crosscheck(FRAME_KERNELS, FRAME_COUNTS)
    assert dict((f, (p, c)) for f, p, c in rows) == {
        "K1": (6.0, 6.0), "K2": (2.0, 2.0), "K3": (14.0, 14.0),
        "K4/K5a/K5b": (17.0, 17.0), "K6": (2.0, 2.0)}
    assert "agree" in verdict and "DISAGREE" not in verdict
    cs.check_frame_launches("int8", FRAME_KERNELS, FRAME_COUNTS)


def test_frame_launch_check_names_the_profiler_when_it_drops_a_record():
    """One K1 record of 20 frames missing from the profiler (5.95 a frame)
    while the counters saw 6: the check fails, and its message says the
    profiler lost the launch and names K1, the one family that differs."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    kern = [(k, us, 5.95 if "decode_attn" in k else c)
            for k, us, c in FRAME_KERNELS]
    with pytest.raises(AssertionError) as err:
        cs.check_frame_launches("int8", kern, FRAME_COUNTS)
    msg = str(err.value)
    assert "profiler lost 0.05" in msg and "K1:" in msg
    assert "K2:" not in msg and "K3:" not in msg
    # the other side: a launch the counters did not see
    _, verdict = cs.launch_crosscheck(
        FRAME_KERNELS, dict(FRAME_COUNTS, fused_pre=7.0))
    assert "K4/K5a/K5b: counters missed 1.00" in verdict


@pytest.mark.parametrize("failing,phase", [
    ("check_conv_kernels", "kernels, quantized convs"),
    ("check_gguf", "gguf"), ("time_conv_kernels", "timing")])
def test_failing_convs_or_gguf_phase_fails_the_run(failing, phase,
                                                   monkeypatch, capsys):
    """The quantized-convs kernel checks (phase 3), the GGUF phase (4c)
    and the convs' kernel times (phase 6): each that raises makes main
    return 1 and name its phase."""
    out = _run_with_one_failing(failing, monkeypatch, capsys)
    assert f"FAILED in phase '{phase}'" in out.err


def test_expected_conv_launches():
    """The quantized-convs paths at DEFAULT_CONFIG: their counterparts'
    launches without the K3 sequence, and per frame 7 more K4a (int8; 5
    of them, of 96 and 480 rows, on the warpgroup kernel) or K4b (int4)
    launches; the serving mode with quantized convs: 7 more K4b and no K3
    a batch frame step."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    for path, mm in (("int8_convs", "int8_matmul"),
                     ("int4_convs", "int4_matmul")):
        frame, prefill = cs.expected_launches(DEFAULT_CONFIG, path)
        base, base_prefill = cs.expected_launches(
            DEFAULT_CONFIG, cs.CONV_COUNTERPART[path])
        assert prefill == base_prefill and "seanet_frame" not in frame
        want = {k: v for k, v in base.items() if k != "seanet_frame"}
        want[mm] += 7
        if mm == "int8_matmul":
            want["int8_matmul_wgmma"] = 5
        assert frame == want
    serve = cs.expected_serving(DEFAULT_CONFIG, cs.SERVE_CONVS, 2, 1)
    base = cs.expected_serving(DEFAULT_CONFIG, cs.KV8_PATH, 2, 1)
    assert "seanet_frame" not in serve
    assert serve["int4_matmul"] == base["int4_matmul"] + 14
    assert {k: v for k, v in serve.items() if k != "int4_matmul"} == {
        k: v for k, v in base.items()
        if k not in ("int4_matmul", "seanet_frame")}


# phase 10 (dormant modules): each step and the phase it names
DORMANT = {"check_native": "dormant modules: native library",
           "check_dormant_kernels": "dormant modules: kernels",
           "dormant_engines": "dormant modules: paths",
           "check_cross_run": "dormant modules: paths",
           "check_dormant_card_vs_cpu": "dormant modules: card vs cpu",
           "check_weights_per_step": "dormant modules: card vs cpu",
           "check_encoder": "dormant modules: encoder",
           "time_dormant": "dormant modules: timing",
           "time_encoder_kernels": "dormant modules: timing"}


@pytest.mark.parametrize("failing", sorted(DORMANT))
def test_failing_dormant_phase_fails_the_run(failing, monkeypatch, capsys):
    """Phase 10: each step that raises makes main return 1, name its phase
    and print no result (the steps before it stubbed to pass)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    class Engine:
        cfg = None

    for name in DORMANT:
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setattr(cs, "dormant_engines", lambda *a, **k: (
        {"cross": Engine(), "gated_rms": Engine()}, {}))
    monkeypatch.setattr(cs, "dormant_launches", lambda *a, **k: {})
    monkeypatch.setattr(cs, "expected_launches", lambda *a, **k: ({}, {}))
    out = _run_with_one_failing(failing, monkeypatch, capsys)
    assert f"FAILED in phase '{DORMANT[failing]}'" in out.err
    assert "[10] dormant modules" in out.out


def _quantized_encoder(cfg, bits):
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.io.quant import quantize_params
    enc = cs._to_tree(cs.encoder_weights(cfg), "cpu", torch.float32)
    return quantize_params(enc, bits=bits, convs=True)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("width", ["tiny64", "default"])
def test_encoder_conv_shapes_agree_with_the_tree(width, bits):
    """encoder_conv_shapes (from the cfg's dims) names exactly the convs
    quantize_params(convs=True) quantizes in an encoder tree, with their
    products and rows: at DEFAULT_CONFIG's dims model_4's and model_7's
    block_1, model_7's block_3 and model_11, at tiny_config(64) the final
    conv alone."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG, tiny_config
    cfg = tiny_config(64) if width == "tiny64" else DEFAULT_CONFIG
    prods = cs.encoder_products(_quantized_encoder(cfg, bits), cfg)
    got = [(name, w.shape[0] * (2 if key.endswith("4") else 1), w.shape[1],
            rows) for name, key, w, _, rows in prods]
    assert got == cs.encoder_conv_shapes(cfg)
    assert all(key == ("qc" if bits == 8 else "qc4")
               for _, key, *_ in prods)
    if width == "default":
        assert got == [("model_4.block_1", 384, 64, 480),
                       ("model_7.block_1", 768, 128, 96),
                       ("model_7.block_3", 128, 256, 96),
                       ("model_11", 1536, 512, 16)]
    else:
        assert [g[0] for g in got] == ["model_11"]


def test_dormant_launches_per_frame():
    """DEFAULT_CONFIG: both dormant paths run 6 K1, 2 K2 and one K3
    sequence a frame in bf16; with int8 weights gated_rms adds the
    backbone's 6 K5a (skinny) + 6 K5b, K6 and 1 + 2 x 4 K4a (no K5 in the
    mimi), cross 1 + 6 x 6 + 2 x 6 K4a and K6, no K5 at all."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    base = {"decode_attn": 6, "ring_attn": 2, "seanet_frame": 1}
    for path in cs.DORMANT_PATHS:
        assert cs.dormant_launches(DEFAULT_CONFIG, path) == base
    assert cs.dormant_launches(DEFAULT_CONFIG, "gated_rms", "int8") == dict(
        base, fused_flow=2, int8_matmul=9, fused_pre=6, fused_post=6,
        rows_skinny=6)
    assert cs.dormant_launches(DEFAULT_CONFIG, "cross", "int8") == dict(
        base, fused_flow=2, int8_matmul=49)


def test_dormant_helpers_on_the_cpu(monkeypatch):
    """The phase's helpers at tiny_config(64) on the CPU: the dormant
    trees (alphas, gating, cross sub-blocks; int8 layouts where they
    quantize), a cross stream holding cross KV that decodes finite
    frames, the card-vs-CPU, weights-per-step, native and kernel checks
    run through (the CPU standing in for the card), and the encoder
    checks without the quantized trees (their launch counts need the
    card)."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import (random_params,
                                                random_voice_prompt)
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    cfg0 = tiny_config(64)
    p, cfg = random_params(cfg0, seed=0)
    ex = cs.dormant_extras(cfg)
    g = cs.dormant_params(p, "gated_rms", ex, "int8")
    lay = g["mimi"]["decoder_transformer"]["layers"]
    assert set(lay["norm1"]) == {"alpha"} and "q" in lay["gating"][
        "linear_in"]
    c = cs.dormant_params(p, "cross", ex)
    assert "cross_attention" in c["layers"] and "norm_cross" in c["mimi"][
        "decoder_transformer"]["layers"]
    assert "cross_attention" not in p["layers"]
    eng = cs.make_engine(cfg, cpu, torch.float32, params=c)
    voice = random_voice_prompt(cfg, 20)
    state, steps = cs.cross_stream(eng, voice, ex)
    assert state.flow.xk is not None and steps > 0
    pcm = cs.stream_frames(eng, state, 3)
    assert pcm.shape == (3, cfg.mimi.frame_size) and np.isfinite(pcm).all()
    monkeypatch.setattr(cs, "_LOG", [])
    cs.check_dormant_card_vs_cpu(cfg0, cpu, voice, ex)
    cs.check_weights_per_step(cfg, cpu)
    cs.check_native()
    trees = cs.check_dormant_kernels(cfg, cpu, {})
    assert set(trees) == {8, 4}
    monkeypatch.setattr(cs, "ENCODER_FRAMES", 2)
    cs.check_encoder(cfg, cpu, {})


def test_failing_mesh_phase_fails_the_run(monkeypatch, capsys):
    """Phase 11 (sharded serving on a mesh of gloo ranks): a failure there
    (a rank's, raised by parallel.launch) makes main return 1, name the
    phase and print no result, every earlier phase stubbed to pass."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    class Engine:
        cfg = None

    for name in DORMANT:
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setattr(cs, "dormant_engines", lambda *a, **k: ({}, {}))
    out = _run_with_one_failing("run_mesh_phase", monkeypatch, capsys)
    assert "FAILED in phase 'mesh'" in out.err
    assert "[11] sharded serving" in out.out


@pytest.mark.parametrize("fuse_insert", [None, False])
def test_mesh_expected_launches_per_step(fuse_insert):
    """A rank's launches per batch frame step on phase 11's server: 6 K7
    int8 with statistics (6 K1 over lanes with statistics without the fused
    insert), 2 K2-q, one K3 sequence; 3 all-reduces a layer a step and 3 a
    backbone layer an admission prefill."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    want, reduces = cs.mesh_expected(fuse_insert, 10, 2)
    k1 = fuse_insert is False
    assert want == {
        "ring_attn_kv8": 20, "seanet_frame": 10,
        "decode_attn_lanes" if k1 else "decode_insert_attn_kv8": 60,
        "decode_attn_stats" if k1 else "decode_insert_attn_stats": 60}
    assert reduces == 3 * 8 * 10 + 3 * 6 * 2
    assert all(name in cs.KERNELS for name in want)
