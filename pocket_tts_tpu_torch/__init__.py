"""pocket-tts-tpu-torch: the PyTorch / NVIDIA H100 port of pocket_tts_tpu.

Solo offline and streaming synthesis (`runtime.engine.TTSEngine`) in
PyTorch, with bf16/f32 weights or int8 weights (`quantize="int8"`), and
the TPU kernels of those paths rewritten as hand-written CUDA kernels for
Hopper (sm_90a): K1 decode attention (ops/decode_attn.py), K2 mimi ring
insert + attention (ops/ring_attn.py), K3 the SEANet decoder frame
(ops/seanet_frame.py), K4a the int8 matmul (ops/quant_matmul.py), K5a/K5b
a transformer layer's fused int8 linears (ops/fused_layer.py) and K6 the
fused int8 flow net (ops/fused_flow.py). Each runs its plain PyTorch
version for tensors on the CPU. The kernels build with nvcc at
first use (ops/cuda_lib.py). This package imports no JAX; it shares the
JAX-free modules of `pocket_tts_tpu` (config, text, io.wav,
io.safetensors_io, native).
"""
__version__ = "0.1.0"
