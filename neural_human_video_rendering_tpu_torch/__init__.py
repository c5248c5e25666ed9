"""Neural human video rendering, ported to PyTorch and CUDA for Hopper.

The JAX package ``neural_human_video_rendering_tpu`` beside this one is the
reference; this package imports nothing of it and keeps its own copies of
the host-side modules it needs. Layout is NCHW throughout; public op
functions that the tests compare with the JAX package keep the JAX layout.

Layer map:
  config     the reference flag surface; --gpu_ids picks the device
  data/      datasets, keypoint JSONs, pose alignment, pose rasterization,
             DensePose / LaplaceProj loading, the texture atlas unfold
  models/    TransG / TexG / BGNet, the encoder E, the NeuralRenderer, the
             discriminator, the VGG, the flax->torch bridge
  ops/       texture and flow warps: plain PyTorch versions + the CUDA kernels
  csrc/      the CUDA sources (sm_90a), built with nvcc at first use
  losses/    GAN, reconstruction, perceptual and temporal losses
  train/     pose-input assembly, the steps, the state, the loop, the drivers
  infer/     the test.py driver: batched forward, PNG frames, gallery, video
  utils/     images, checkpoints, metrics, visualizer, HTML gallery, video
  parallel/  data parallel over ranks: the mesh's batch split, gradient
             average, replication and checksums; a self-check
  runtime    ranks, devices and the backend (--gpu_ids, torchrun)
Entry points (python -m neural_human_video_rendering_tpu_torch.<name>):
  pre_train, pre_train_tex, train, infer.test_driver, unfold_texture,
  graph_posenorm, encode_features, profile_step, and launch (a reference
  launcher script's own argv through these).
"""

__version__ = "0.1.0"
