"""Quality evaluation between a rendered-frames directory and a
ground-truth directory (PSNR, SSIM, VGG distance; --metric lpips,temporal
adds LPIPS and flicker), the port's evaluate.py:

    python -m neural_human_video_rendering_tpu_torch.evaluate \\
        --results_dir OUT/images --gt_dir FRAMES

(--gpu_ids -1 for the CPU; the card otherwise). Prints one JSON line with
the mean metrics (``infer/evaluate.py``).
"""

from .infer.evaluate import main

if __name__ == "__main__":
    main()
