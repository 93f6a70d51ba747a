"""pocket-tts-tpu-torch: the PyTorch / NVIDIA H100 port of pocket_tts_tpu.

Solo offline and streaming synthesis (`runtime.engine.TTSEngine`) in
PyTorch, with bf16/f32 weights or quantized ones (`quantize="int8"`,
`"int4"`, `"q4_0"`) and optionally the int8 backbone KV cache
(`quantize_kv=True`), and continuous-batching serving of many streams
(`runtime.server.ContinuousBatchingServer`, `MultiStreamServer`,
`runtime.batched.BatchedEngine`, CLI `--serve`) with the same options and
shared-prefix serving (`share_prefix=True`, `--share-prefix`).
The TPU kernels of those paths are rewritten as hand-written CUDA kernels
for Hopper (sm_90a): K1 decode attention (ops/decode_attn.py), K2 mimi
ring insert + attention (ops/ring_attn.py), K3 the SEANet decoder frame
(ops/seanet_frame.py), K4a / K4b the int8 / int4 matmul
(ops/quant_matmul.py), K5a/K5b a transformer layer's fused quantized
linears (ops/fused_layer.py), K6 the fused quantized flow net
(ops/fused_flow.py) and K7 the fused KV-row insert + decode attention of
batched decode (ops/insert_attn.py). K2, K3 and K7 take a lane axis, K1
and K7 int8 caches, K7 returns flash statistics, and K5a/K5b/K6 take the
rows of all lanes. Each
runs its plain PyTorch version for tensors on the CPU. The kernels build
with nvcc at first use (ops/cuda_lib.py). `io.quant` also reads and
writes the JAX package's params cache. The modules a checkpoint switches
on load and run as in the JAX package: SwiGLU gating (ops/gating.py),
RMSNorm alphas, cross-attention and the SEANet encoder. `native` builds
the runtime library (csrc/native/) with the host compiler at first use.
This package imports nothing of JAX, ml_dtypes or the JAX package: it
keeps its own copies of the configuration (config.py), the text front end
(text/), the WAV and safetensors readers (io/).
"""
__version__ = "0.1.0"
