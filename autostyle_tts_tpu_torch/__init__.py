"""PyTorch/CUDA port of ``autostyle_tts_tpu`` for one NVIDIA H100.

Laid out like the JAX package so each counterpart is easy to find:
``utils/`` (config, device, timing), ``ops/`` (attention, sampling, conv,
iSTFT, retrieval top-k and the two hand-written CUDA kernels' wrappers),
``models/`` (transformer core, speech-token LM, CFM, vocoder, frontend),
``retrieval/`` (StyleStore), ``pipeline/`` (Engine), ``train/`` (the
acoustic stages, CFM distillation, the embedder's LoRA SFT), ``cli/`` and
``csrc/`` (the ``.cu`` sources, built with nvcc on first use).

The package imports torch, numpy and the standard library only. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch twin.
"""
