"""Neural human video rendering, ported to PyTorch and CUDA for Hopper.

The JAX package ``neural_human_video_rendering_tpu`` beside this one is the
reference; this package imports nothing of it and keeps its own copies of
the host-side modules it needs. Layout is NCHW throughout; public op
functions that the tests compare with the JAX package keep the JAX layout.

Layer map (the serving path, keypoints -> frames):
  config     the reference flag surface; --gpu_ids picks the device
  data/      keypoint JSONs, pose alignment, pose rasterization, assets
  models/    TransG / TexG / BGNet generators and the NeuralRenderer
  ops/       texture warp: plain PyTorch versions + the CUDA kernels
  csrc/      the CUDA sources (sm_90a), built with nvcc at first use
  train/     pose-input assembly and the inference forward
  infer/     the test.py driver: batched forward, PNG frames, gallery
  utils/     uint8 conversion, PNG writer, HTML gallery
"""

__version__ = "0.1.0"
