"""Port loader vs the JAX loader: bit-identical random checkpoints, and
params_from_flat == from_jax_numpy(JAX params) leaf for leaf."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import DEFAULT_CONFIG, tiny_config
from pocket_tts_tpu.io import params as jparams
from pocket_tts_tpu.io.safetensors_io import save_safetensors
from pocket_tts_tpu_torch.config import (check_supported,
                                         reference_exact_config)
from pocket_tts_tpu_torch.io import params as tparams

torch.set_num_threads(1)
CFG0 = tiny_config()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_flat_bit_identical(seed):
    a = jparams.random_flat(CFG0, seed)
    b = tparams.random_flat(CFG0, seed)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("length,seed", [(32, 1), (120, 5)])
def test_random_voice_prompt_bit_identical(length, seed):
    np.testing.assert_array_equal(
        jparams.random_voice_prompt(DEFAULT_CONFIG, length, seed),
        tparams.random_voice_prompt(DEFAULT_CONFIG, length, seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_params_from_flat_equals_bridge(seed):
    flat = tparams.random_flat(CFG0, seed)
    pj, cfg_j = jparams.params_from_flat(flat, CFG0)
    pt, cfg_t = tparams.params_from_flat(flat, CFG0)
    # each package builds its config from its own dataclasses
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    bridged = tparams.from_jax_numpy(jax.tree.map(np.asarray, pj))
    lt = dict(_leaves(pt))
    lb = dict(_leaves(bridged))
    assert sorted(lt) == sorted(lb)
    for k in lt:
        assert lt[k].shape == lb[k].shape, k
        assert lt[k].dtype == lb[k].dtype, k
        if k == "/_time_cond":   # computed by each package's own ops
            torch.testing.assert_close(lt[k], lb[k], atol=1e-5, rtol=0)
        else:
            assert torch.equal(lt[k], lb[k]), k


def test_params_from_flat_bf16_weights_equal():
    flat = tparams.random_flat(CFG0, 2)
    pj, _ = jparams.params_from_flat(flat, CFG0, jnp.bfloat16)
    pt, _ = tparams.params_from_flat(flat, CFG0, torch.bfloat16)
    bridged = dict(_leaves(tparams.from_jax_numpy(
        jax.tree.map(np.asarray, pj))))
    for k, v in _leaves(pt):
        assert v.dtype == torch.bfloat16, k
        if k != "/_time_cond":
            assert torch.equal(v, bridged[k]), k


def test_rope_permutation_matches():
    flat = tparams.random_flat(CFG0, 4)
    pj, _ = jparams.params_from_flat(flat, CFG0)
    pt, _ = tparams.params_from_flat(flat, CFG0)
    np.testing.assert_array_equal(
        np.asarray(pj["layers"]["in_proj"]["w"]),
        pt["layers"]["in_proj"]["w"].numpy())
    # the q block is permuted, the v block is not
    w = flat["flow_lm.transformer.layers.0.self_attn.in_proj.weight"].T
    dm = CFG0.backbone.d_model
    assert not np.array_equal(pt["layers"]["in_proj"]["w"][0, :, :dm],
                              w[:, :dm])
    np.testing.assert_array_equal(
        pt["layers"]["in_proj"]["w"][0, :, 2 * dm:].numpy(), w[:, 2 * dm:])


def test_load_checkpoint_and_voice(tmp_path):
    flat = tparams.random_flat(CFG0, 5)
    path = str(tmp_path / "ckpt.safetensors")
    save_safetensors(flat, path)
    a, cfg_a = tparams.load_checkpoint(path, CFG0)
    b, cfg_b = tparams.params_from_flat(flat, CFG0)
    assert cfg_a == cfg_b
    for (ka, va), (kb, vb) in zip(_leaves(a), _leaves(b)):
        assert ka == kb and torch.equal(va, vb), ka
    prompt = tparams.random_voice_prompt(CFG0, 9)
    vpath = str(tmp_path / "voice.safetensors")
    save_safetensors({"voice.audio_prompt": prompt[None]}, vpath)
    np.testing.assert_array_equal(tparams.load_voice(vpath).numpy(), prompt)
    np.testing.assert_array_equal(np.asarray(jparams.load_voice(vpath)),
                                  prompt)


def _exact_masks_on_kernels(cfg):
    """The reference-exact masks with the kernel routes switched on."""
    cfg = reference_exact_config(cfg)
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_attn=None),
        mimi=dataclasses.replace(cfg.mimi, transformer=dataclasses.replace(
            cfg.mimi.transformer, use_pallas_attn=True)))


def _apply(obj, ch):
    return dataclasses.replace(obj, **{
        k: (_apply(getattr(obj, k), v) if isinstance(v, dict) else v)
        for k, v in ch.items()})


@pytest.mark.parametrize("change", [
    dict(mimi=dict(seanet=dict(mesh="data"))),
    dict(backbone=dict(mesh="data")),
    dict(backbone=dict(mask_value=-1e5)),
    dict(mimi=dict(transformer=dict(mask_value=-1e5))),
    dict(on_mesh=True),
    _exact_masks_on_kernels,
    dict(mimi=dict(transformer=dict(capacity=250))),
    dict(backbone=dict(mask_value=-1e5, use_pallas_attn=True)),
])
def test_unsupported_config_raises(change):
    """What the port refuses: a mesh, and on a part whose use_pallas_attn
    is not False (the kernel route) mask values other than -1e9 (its
    kernels mask with -1e9; the JAX kernels would ignore the value) and a
    mimi capacity off the upsample stride (K2 inserts whole 16-step
    blocks). The megalayer, the bilayer
    and the int8 mimi ring run (test_supported_slice6_options), and so
    does the reference-exact mode (test_reference_exact_is_supported)."""
    check_supported(CFG0)
    cfg = change(CFG0) if callable(change) else _apply(CFG0, change)
    with pytest.raises(NotImplementedError, match="not ported"):
        check_supported(cfg)


@pytest.mark.parametrize("change", [
    reference_exact_config,
    dict(mimi=dict(transformer=dict(capacity=250, use_pallas_attn=False))),
    dict(backbone=dict(mask_value=-1e5, use_pallas_attn=False)),
])
def test_reference_exact_is_supported(change):
    """The reference-exact mode runs (its -1e5 masks and 250-slot ring on
    the plain routes use_pallas_attn=False picks), and so does each of
    those parts alone on its plain route."""
    cfg = change(CFG0) if callable(change) else _apply(CFG0, change)
    check_supported(cfg)


def test_supported_slice6_options():
    cfg = dataclasses.replace(
        CFG0, backbone=dataclasses.replace(
            CFG0.backbone, use_megalayer=True, use_bilayer=True),
        mimi=dataclasses.replace(CFG0.mimi, transformer=dataclasses.replace(
            CFG0.mimi.transformer, quantize_kv=True)))
    check_supported(cfg)


def _module_keys(flat, key):
    """Give `flat` the whole module that `key` names, in every layer
    (the layers stack), with well-shaped weights from a seeded numpy
    RandomState: a backbone layer's cross sub-block, a mimi layer's
    gating, a mimi norm as an RMSNorm alpha (its weight/bias dropped), or
    the SEANet encoder."""
    if ".layers.0." in key:
        for i in range(CFG0.backbone.num_layers):
            flat = _module_keys(flat, key.replace(".layers.0.",
                                                  f".layers#{i}."))
        return {k.replace("#", "."): v for k, v in flat.items()}
    key = key.replace("#", ".")
    rng = np.random.RandomState(2)
    if ".cross_attention." in key:
        d = CFG0.backbone.d_model
        pre = key[:key.index("cross_attention.")]
        flat[pre + "norm_cross.weight"] = rng.randn(d).astype(np.float32)
        flat[pre + "norm_cross.bias"] = rng.randn(d).astype(np.float32)
        flat[key] = rng.randn(3 * d, d).astype(np.float32)
        flat[pre + "cross_attention.out_proj.weight"] = rng.randn(
            d, d).astype(np.float32)
    elif ".gating." in key:
        d = CFG0.mimi.transformer.d_model
        flat[key] = rng.randn(4 * d, d).astype(np.float32)
    elif key.endswith(".alpha"):
        del flat[key[:-6] + ".weight"], flat[key[:-6] + ".bias"]
        flat[key] = rng.randn(CFG0.mimi.transformer.d_model).astype(
            np.float32)
    else:
        sc = CFG0.mimi.seanet
        n = len(sc.stages)
        shapes = {"0.conv": (sc.stages[-1].out_ch, sc.out_ch,
                             sc.first_kernel),
                  f"{3 * n + 2}.conv": (sc.in_ch, sc.stages[0].in_ch,
                                        sc.last_kernel)}
        for gi, st in enumerate(reversed(sc.stages)):
            c = st.out_ch
            shapes[f"{3 * gi + 1}.block.1.conv"] = (c // 2, c,
                                                    sc.resnet_kernel)
            shapes[f"{3 * gi + 1}.block.3.conv"] = (c, c // 2, 1)
            shapes[f"{3 * gi + 3}.conv"] = (st.in_ch, st.out_ch, st.kernel)
        for name, shape in shapes.items():
            flat[f"mimi.encoder.model.{name}.weight"] = rng.randn(
                *shape).astype(np.float32)
            flat[f"mimi.encoder.model.{name}.bias"] = rng.randn(
                shape[0]).astype(np.float32)
    return flat


@pytest.mark.parametrize("key", [
    "flow_lm.transformer.layers.0.cross_attention.in_proj.weight",
    "mimi.decoder_transformer.transformer.layers.0.gating.linear_in.weight",
    "mimi.decoder_transformer.transformer.layers.0.norm1.alpha",
    "mimi.encoder.model.0.conv.weight",
])
def test_unported_checkpoint_modules_raise(key):
    """The modules a checkpoint switches on, once refused, now load as the
    JAX loader loads them, leaf for leaf; a `.gating.` key is ignored, as
    the JAX loader ignores it."""
    flat = _module_keys(tparams.random_flat(CFG0, 1), key)
    pt, _ = tparams.params_from_flat(flat, CFG0)
    pj, _ = jparams.params_from_flat(flat, CFG0)
    got, want = dict(_leaves(pt)), dict(_leaves(
        jax.tree.map(np.asarray, pj)))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        if path == "/_time_cond":     # computed, not loaded: float32 ulps
            np.testing.assert_allclose(got[path].numpy(), leaf, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[path].numpy(), leaf,
                                          err_msg=path)
    plain = dict(_leaves(tparams.params_from_flat(
        tparams.random_flat(CFG0, 1), CFG0)[0]))
    if ".gating." in key:
        assert sorted(got) == sorted(plain)
    elif ".cross_attention." in key:
        assert got["/layers/cross_attention/in_proj/w"].shape == (
            CFG0.backbone.num_layers, CFG0.backbone.d_model,
            3 * CFG0.backbone.d_model)
        assert "/layers/norm_cross/scale" in got
    elif key.endswith(".alpha"):
        lay = pt["mimi"]["decoder_transformer"]["layers"]
        assert set(lay["norm1"]) == {"alpha"} and "scale" in lay["norm2"]
    else:
        assert "/mimi/encoder/model_11/w" in got
