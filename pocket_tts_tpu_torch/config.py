"""Model configuration for the PyTorch port.

The port's own copy of the dataclasses of `pocket_tts_tpu/config.py`
(`ModelConfig`, `DEFAULT_CONFIG`, `tiny_config`, `reference_exact_config`),
field for field, so a configuration means the same in both packages
(tests/test_torch_config.py compares them). The comments on the fields
describe the JAX package's switches; the port reads the model's
dimensions, `kv_capacity`, `gelu_approx`, `eos_threshold`, the two
`quantize_kv` fields, `backbone.fuse_insert`, `backbone.use_megalayer`,
`backbone.use_bilayer`, the two `mask_value` fields and the two
`use_pallas_attn` fields.

`check_supported` names what this port runs: solo decode and
continuous-batching serving (runtime/batched.py, runtime/server.py, with
shared-prefix serving; sharded over a mesh) with
bf16/f32, int8, int4 or q4_0 weights
(quantization is an engine option, not a config field), with the
backbone's KV cache in the working type or in int8 with per-row scales
(`backbone.quantize_kv`; the engine's `quantize_kv=True` sets it), and the
mimi ring in int8 with per-row scales (`mimi.transformer.quantize_kv`, a
config-only option, kernel K2's int8 variant).
`backbone.fuse_insert` routes each T = 1 decode step through kernel K7
(ops/insert_attn.py) instead of a row write and kernel K1; the serving
paths set it unless the caller did (`runtime.batched.mesh_cfg`).
`backbone.use_megalayer` runs a solo quantized T = 1 layer as ONE launch
of kernel K8 (ops/fused_step.py); `backbone.use_bilayer` fuses post(l)
with pre(l+1) for solo int4 decode through kernel K5c
(ops/fused_layer.bilayer_post_pre).

The reference-exact mode (`reference_exact_config`: tanh GELU, a -1e5
mask, a 250-slot mimi ring) runs, and the model picks its route from the
cfg as the JAX model does. `use_pallas_attn=False` (either field) is the
JAX package's XLA route: the backbone decodes with plain attention under
`pos_cache_bias(..., neg=mask_value)` and without K1, K7, K8 and the
fused K5a/K5b/K5c (its linears go through K4a/K4b when quantized); the
mimi transformer takes the plain ring path (a row-scatter insert and
`ring_cache_bias(..., neg=mask_value)`) when its `use_pallas_attn` is
False. None and True are the kernel routes (K1/K7/K8/K5 and K2). K3,
K4a/K4b and K6 read no switch and run either way. On a part whose
`use_pallas_attn` is not False, a mask other than -1e9 raises (the
kernels mask with -1e9; the JAX kernels would ignore the value
silently), and so does a mimi capacity that is not a multiple of the
upsample stride (K2 inserts whole 16-step blocks; the JAX model would
take its XLA route there instead, `models/mimi_transformer.py:205-221`).
The mesh fields (`backbone.mesh`, `mimi.transformer.mesh`,
`mimi.seanet.mesh`, `on_mesh`) carry a torch DeviceMesh with dims
("data", "model") (parallel/sharding.make_mesh) into the decode of a
sharded serving run; `runtime.batched.mesh_cfg` sets them, and a mesh of
another kind, or `on_mesh` without the SEANet's mesh, raises. So no
configuration silently runs something other than what it asks for.

`MoshiConfig` (with `MoshiDepthConfig`, `RvqConfig` and its Mimi,
`MOSHI_MIMI`) sizes the port's second architecture, Moshi, which the
same continuous-batching server runs (models/moshi.py, runtime/moshi.py);
`tiny_moshi_config` is its CPU test size.

The kernel wrappers keep their one rule either way: plain PyTorch for
tensors on the CPU, the hand-written CUDA kernel (or an error) for
tensors on the card. The model calls the plain functions by cfg, never
because a kernel failed. `mimi.seanet.use_pallas` is not read.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Flow-matching MLP (SimpleMLPAdaLN). ref: src/config.h:3-6."""
    depth: int = 6
    dim: int = 512
    # frequency-embedding half-size of the TimestepEmbedder; the reference
    # infers this from the checkpoint's `freqs` tensor
    # (src/pocket_tts/modules/mlp.h:86).
    freq_half: int = 128
    # hidden width of each ResBlock MLP; inferred from checkpoint in practice.
    mlp_hidden: int = 512


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """FlowLM streaming transformer. ref: src/config.h:8-14."""
    d_model: int = 1024
    hidden_scale: int = 4
    max_period: int = 10000
    num_heads: int = 16
    num_layers: int = 6
    # KV capacity; the reference allocates seq-len 1000 states
    # (src/pocket_tts.cpp:367-368) — rounded up to 1024 here so cache reads
    # tile cleanly into 128-slot blocks (strictly more headroom).
    kv_capacity: int = 1024
    # the JAX package's Pallas decode-attention switch: False takes the
    # plain decode route (the reference-exact mode), None/True the kernels
    use_pallas_attn: bool = None
    # int8 KV cache with per-row absmax scales
    quantize_kv: bool = False
    # fold the T = 1 KV-row insert into the decode-attention kernel
    # (K7). None = auto: on for batched serving (set by the serving
    # cfg helper of each package), off for solo decode
    fuse_insert: bool = None
    # whole-layer megakernel for solo quantized decode (kernel K8)
    use_megalayer: bool = False
    # post(l) + pre(l+1) bilayer kernel for solo int4 decode (kernel K5c)
    use_bilayer: bool = False
    # additive bias for masked attention slots: -1e9 (ours, negligible after
    # softmax) vs the reference's -1e5 "can't use infinity" hack
    # (torch.h:124-143). A/B switch for real-weights bit comparison.
    mask_value: float = -1e9
    # the ("data", "model") DeviceMesh of a sharded decode: heads and MLP
    # width split over "model" (runtime.batched.mesh_cfg sets it)
    mesh: object = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def hidden_dim(self) -> int:
        return self.d_model * self.hidden_scale


@dataclasses.dataclass(frozen=True)
class LookupTableConfig:
    """Text conditioner. ref: src/config.h:16-21."""
    dim: int = 1024
    n_bins: int = 4000
    tokenizer: str = "sentencepiece"
    tokenizer_path: str = "tokenizer.model"


@dataclasses.dataclass(frozen=True)
class MimiTransformerConfig:
    """Mimi decoder transformer. ref: src/pocket_tts/models/defaults.h:3-42."""
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 2
    hidden_dim: int = 2048
    context: int = 250
    # ring capacity: the reference uses 250 (= context); rounded up to a
    # multiple of the 16-step frame so the ring insert is a contiguous,
    # in-place dynamic_update_slice (a scatter copies the whole cache every
    # frame). The attention window is still `context`; the only semantic
    # delta is that queries early in a block can see up to 6 slots the
    # reference's ring had already overwritten — i.e. closer to the true
    # 250-step sliding window.
    capacity: int = 256
    # int8 ring KV with per-row absmax scales (kernel K2's int8 variant)
    quantize_kv: bool = False
    # the JAX package's Pallas ring-kernel switch: False takes the plain
    # ring route (the reference-exact mode), None/True kernel K2
    use_pallas_attn: bool = None
    max_period: int = 10000
    # eps=0 LayerNorm (defaults.h:14,32)
    norm_eps: float = 0.0
    # masked-slot bias; -1e5 in reference-exact mode (torch.h:141)
    mask_value: float = -1e9
    # the ("data", "model") DeviceMesh of a sharded decode: heads and MLP
    # width split over "model" (runtime.batched.mesh_cfg sets it)
    mesh: object = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class SeanetStage:
    """One (conv-transpose, resnet) upsampling stage of the SEANet decoder."""
    in_ch: int
    out_ch: int
    kernel: int
    stride: int


@dataclasses.dataclass(frozen=True)
class SeanetConfig:
    """SEANet decoder. ref: src/pocket_tts/models/defaults.h:44-122."""
    in_ch: int = 512
    first_kernel: int = 7           # model.0: conv k7 s1
    stages: tuple = (
        SeanetStage(512, 256, 12, 6),   # model.2
        SeanetStage(256, 128, 10, 5),   # model.5
        SeanetStage(128, 64, 8, 4),     # model.8
    )
    resnet_kernel: int = 3          # block.1 conv k3 s1 (channels halved)
    last_kernel: int = 3            # model.11: conv k3 s1 -> 1 channel
    out_ch: int = 1
    # the JAX package's Pallas SEANet switch; not read by the port
    use_pallas: bool = None
    # the DeviceMesh of a sharded decode (each rank decodes its own
    # lanes, weights whole)
    mesh: object = None

    @property
    def total_stride(self) -> int:
        s = 1
        for st in self.stages:
            s *= st.stride
        return s


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    """Mimi decode chain. ref: src/config.h:30-46, models/mimi.h:10-28."""
    sample_rate: int = 24000
    channels: int = 1
    frame_rate: float = 12.5
    latent_dim: int = 32            # quantizer.dimension
    dim: int = 512                  # quantizer.output_dimension
    upsample_kernel: int = 32       # depthwise convtr k32 s16 groups=512
    upsample_stride: int = 16
    transformer: MimiTransformerConfig = MimiTransformerConfig()
    seanet: SeanetConfig = SeanetConfig()

    @property
    def frame_size(self) -> int:
        # 16 * (6*5*4) = 1920 samples / 80ms frame
        return self.upsample_stride * self.seanet.total_stride


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full pocket-tts model configuration (reference defaults)."""
    flow: FlowConfig = FlowConfig()
    backbone: BackboneConfig = BackboneConfig()
    lut: LookupTableConfig = LookupTableConfig()
    mimi: MimiConfig = MimiConfig()
    latent_dim: int = 32
    eos_threshold: float = -4.0     # ref: models/flow_lm.h:94
    # GELU flavour: "erf" matches the original Python model (torch F.gelu
    # default); the ggml reference uses the tanh approximation
    # (torch.h / ggml_gelu). Configurable for A/B numerics.
    gelu_approx: bool = False
    # True when the decode runs on a mesh (runtime.batched.mesh_cfg): the
    # flow net then never takes kernel K6, as the JAX package gates it
    on_mesh: bool = False


def reference_exact_config(base: "ModelConfig" = None) -> "ModelConfig":
    """ggml-reference-exact numerics: the A/B switchboard for real-weights
    bit comparison against the C++ build. Flips every documented divergence:

    - tanh GELU (ggml_gelu) instead of erf (torch.h analog)
    - mask bias -1e5 instead of -1e9 (torch.h:141)
    - mimi ring capacity == context == 250 (defaults.h:5-7) — the insert
      becomes a row scatter (slow path) but slot eviction order matches the
      reference exactly.
    - XLA decode attention (use_pallas_attn=False): the Mosaic kernel
      hard-codes the -1e9 mask and accumulates bf16 kernel numerics.

    Engine-level dtype (f32 vs bf16) stays a TTSEngine(dtype=...) choice.
    """
    base = base or DEFAULT_CONFIG
    return dataclasses.replace(
        base,
        gelu_approx=True,
        backbone=dataclasses.replace(base.backbone, mask_value=-1e5,
                                     use_pallas_attn=False),
        mimi=dataclasses.replace(
            base.mimi,
            transformer=dataclasses.replace(
                base.mimi.transformer, mask_value=-1e5,
                use_pallas_attn=False,
                capacity=base.mimi.transformer.context)),
    )


def tiny_config(seed_dims: int = 16) -> ModelConfig:
    """A miniature config for fast CPU tests; same topology, tiny dims."""
    d = seed_dims  # 16
    return ModelConfig(
        flow=FlowConfig(depth=2, dim=2 * d, freq_half=8, mlp_hidden=2 * d),
        backbone=BackboneConfig(
            d_model=4 * d, hidden_scale=2, num_heads=4, num_layers=2,
            kv_capacity=128),
        lut=LookupTableConfig(dim=4 * d, n_bins=256),
        mimi=MimiConfig(
            latent_dim=8, dim=2 * d,
            transformer=MimiTransformerConfig(
                d_model=2 * d, num_heads=2, num_layers=2, hidden_dim=4 * d,
                context=40, capacity=48),
            seanet=SeanetConfig(
                in_ch=2 * d,
                stages=(
                    SeanetStage(2 * d, d, 12, 6),
                    SeanetStage(d, d // 2, 10, 5),
                    SeanetStage(d // 2, d // 4, 8, 4),
                ),
            ),
        ),
        latent_dim=8,
    )


DEFAULT_CONFIG = ModelConfig()


# ---------------------------------------------------------------------------
# Moshi: the full-duplex speech-text model over Mimi (models/moshi.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoshiDepthConfig:
    """The depth transformer ("depformer"): one sub-step a codebook, each
    with its own linears (`depformer_weights_per_step`), causal over the
    frame's sub-steps, no positional embedding, no final norm."""
    d_model: int = 1024
    num_heads: int = 16
    num_layers: int = 6
    hidden: int = 2816          # SwiGLU width: 2 * floor(4.125 * 1024) // 3
    steps: int = 8              # sub-steps a frame: Moshi's codebooks

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class RvqConfig:
    """Mimi's split residual vector quantizer (decode side): the first
    `n_semantic` codebooks and the rest each summed, each group through
    its own 1x1 projection dim -> mimi.dim, the two added."""
    n_q: int = 8
    bins: int = 2048
    dim: int = 256
    n_semantic: int = 1


# Mimi as Moshi runs it: 8 codebooks at 12.5 Hz, a x2 depthwise upsample
# (k4 s2) to the 25 Hz transformer of 8 layers, SEANet with four stages
# (strides 8, 6, 5, 4) behind a first conv 512 -> 1024
MOSHI_MIMI = MimiConfig(
    latent_dim=256, dim=512, upsample_kernel=4, upsample_stride=2,
    transformer=MimiTransformerConfig(
        d_model=512, num_heads=8, num_layers=8, hidden_dim=2048,
        context=250, capacity=256, norm_eps=1e-5),
    seanet=SeanetConfig(
        in_ch=512,
        stages=(SeanetStage(1024, 512, 16, 8), SeanetStage(512, 256, 12, 6),
                SeanetStage(256, 128, 10, 5), SeanetStage(128, 64, 8, 4))))


@dataclasses.dataclass(frozen=True)
class MoshiConfig:
    """Moshi 7B (kyutai/moshiko-pytorch-bf16; `_lm_kwargs` of
    moshi/models/loaders.py): a temporal transformer over 17 summed token
    streams a frame (text, Moshi's n_q codebooks, the user's n_q), a depth
    transformer that samples Moshi's codebooks one after another, and
    Mimi's decoder for Moshi's codes. `delays` is the delay of each stream
    in grid steps (text, Moshi's codebooks, the user's); a slot before a
    stream's first token holds the initial token (`text_card`, `card`).
    Sampling: top-k from the softmax at a temperature, text and audio
    each their own."""
    d_model: int = 4096
    num_heads: int = 32
    num_layers: int = 32
    hidden: int = 11264         # SwiGLU width: 2 * floor(4.125 * 4096) // 3
    context: int = 3000         # attention window, in frames
    kv_capacity: int = 3072     # ring slots (a multiple of 8 above context)
    max_period: int = 10000
    norm_eps: float = 1e-8      # rms_norm_f32
    text_card: int = 32000
    card: int = 2048
    n_q: int = 8
    delays: tuple = (0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1)
    text_temp: float = 0.7
    text_topk: int = 25
    audio_temp: float = 0.8
    audio_topk: int = 250
    depth: MoshiDepthConfig = MoshiDepthConfig()
    rvq: RvqConfig = RvqConfig()
    mimi: MimiConfig = MOSHI_MIMI

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def streams(self) -> int:
        """Token streams a frame: text, then Moshi's and the user's."""
        return 1 + 2 * self.n_q

    @property
    def frame_size(self) -> int:
        return self.mimi.frame_size


def tiny_moshi_config() -> MoshiConfig:
    """A miniature Moshi for CPU tests: the same topology (four SEANet
    stages, a widening first conv, a split RVQ, a window shorter than the
    ring), tiny widths."""
    d = 16
    return MoshiConfig(
        d_model=4 * d, num_heads=4, num_layers=2, hidden=88, context=20,
        kv_capacity=24, text_card=40, card=16, n_q=4,
        delays=(0, 0, 1, 1, 1, 0, 1, 1, 1), text_topk=5, audio_topk=6,
        depth=MoshiDepthConfig(d_model=2 * d, num_heads=2, num_layers=2,
                               hidden=40, steps=4),
        rvq=RvqConfig(n_q=4, bins=16, dim=8, n_semantic=1),
        mimi=MimiConfig(
            latent_dim=8, dim=2 * d, upsample_kernel=4, upsample_stride=2,
            transformer=MimiTransformerConfig(
                d_model=2 * d, num_heads=2, num_layers=2, hidden_dim=4 * d,
                context=12, capacity=16, norm_eps=1e-5),
            seanet=SeanetConfig(
                in_ch=2 * d,
                stages=(SeanetStage(4 * d, 2 * d, 16, 8),
                        SeanetStage(2 * d, d, 12, 6),
                        SeanetStage(d, d // 2, 10, 5),
                        SeanetStage(d // 2, d // 4, 8, 4)))))


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for any option this port does not run: a
    mesh that is not a torch DeviceMesh with dims ("data", "model") (a JAX
    Mesh, say), `on_mesh` without `mimi.seanet.mesh` or the reverse (a mesh
    cfg comes from runtime.batched.mesh_cfg, which sets both), and on a
    part whose `use_pallas_attn` is not False (the kernel route) a mask
    value other than -1e9 or a mimi capacity that is not a multiple of the
    upsample stride."""
    bb = cfg.backbone
    mt = cfg.mimi.transformer
    bad = []
    for name, mesh in (("backbone", bb.mesh), ("mimi.transformer", mt.mesh),
                       ("mimi.seanet", cfg.mimi.seanet.mesh)):
        dims = getattr(mesh, "mesh_dim_names", None) or ()
        if mesh is not None and not {"data", "model"} <= set(dims):
            bad.append(f"{name}.mesh={mesh!r} (the port runs a torch "
                       "DeviceMesh with dims ('data', 'model'): "
                       "parallel.sharding.make_mesh)")
    if cfg.on_mesh != (cfg.mimi.seanet.mesh is not None):
        bad.append(f"on_mesh={cfg.on_mesh} with mimi.seanet.mesh="
                   f"{cfg.mimi.seanet.mesh!r} (build a mesh cfg with "
                   "runtime.batched.mesh_cfg, which sets both)")
    if mt.capacity % cfg.mimi.upsample_stride \
            and mt.use_pallas_attn is not False:
        bad.append(f"mimi.transformer.capacity={mt.capacity} with "
                   f"use_pallas_attn={mt.use_pallas_attn} (kernel K2 needs "
                   f"a multiple of {cfg.mimi.upsample_stride}; set "
                   "use_pallas_attn=False, as reference_exact_config does)")
    for name, part in (("backbone", bb), ("mimi.transformer", mt)):
        if part.mask_value != -1e9 and part.use_pallas_attn is not False:
            bad.append(f"{name}.mask_value={part.mask_value} with "
                       f"use_pallas_attn={part.use_pallas_attn} (the "
                       "kernels mask with -1e9; set use_pallas_attn=False, "
                       "as reference_exact_config does)")
    if bad:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(bad))
