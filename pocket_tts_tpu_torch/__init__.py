"""pocket-tts-tpu-torch: the PyTorch / NVIDIA H100 port of pocket_tts_tpu.

Solo offline and streaming synthesis (`runtime.engine.TTSEngine`) in
PyTorch, with bf16/f32 weights or quantized ones (`quantize="int8"`,
`"int4"`, `"q4_0"`), and the TPU kernels of those paths rewritten as
hand-written CUDA kernels for Hopper (sm_90a): K1 decode attention
(ops/decode_attn.py), K2 mimi ring insert + attention (ops/ring_attn.py),
K3 the SEANet decoder frame (ops/seanet_frame.py), K4a / K4b the int8 /
int4 matmul (ops/quant_matmul.py), K5a/K5b a transformer layer's fused
quantized linears (ops/fused_layer.py) and K6 the fused quantized flow net
(ops/fused_flow.py). Each runs its plain PyTorch version for tensors on
the CPU. The kernels build with nvcc at first use (ops/cuda_lib.py).
`io.quant` also reads and writes the JAX package's params cache. This
package imports no JAX; it shares the JAX-free modules of
`pocket_tts_tpu` (config, text, io.wav, io.safetensors_io, native).
"""
__version__ = "0.1.0"
