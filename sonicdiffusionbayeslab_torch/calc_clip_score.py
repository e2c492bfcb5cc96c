"""Standalone CLIP-score CLI: the mean CLIP score of a folder of images
against their captions.

    python -m sonicdiffusionbayeslab_torch.calc_clip_score \
        --folder_path <images_dir> --prompts_file <img2ann.json> \
        [--batch_size 32] [--model_name_or_path openai/clip-vit-base-patch16] \
        [--image_size N] [--tiny] [--device cpu]

Counterpart of ``sonicdiffusionbayeslab_tpu/calc_clip_score.py``, with the
same flags and ``--device`` (CUDA unless given).  Images are read by the
port's decoder; with ``--image_size`` they are resized and center-cropped,
else every image of a batch must have one size.
"""

from __future__ import annotations

import argparse

from sonicdiffusionbayeslab_torch.data.dataset import ImageDatasetWithPrompts, batched
from sonicdiffusionbayeslab_torch.metrics import ClipScoreMetric


def calc_clip_score(
    folder_path: str,
    prompts_file: str,
    batch_size: int = 32,
    model_name_or_path: str = "openai/clip-vit-base-patch16",
    image_size: int | None = None,
    tiny: bool = False,
    device=None,
) -> float:
    dataset = ImageDatasetWithPrompts(folder_path, prompts_file, image_size)
    metric = ClipScoreMetric(model_name_or_path, tiny=tiny, device=device)
    for batch in batched(dataset, batch_size):
        metric.update(batch["image"], batch["prompt"])
    return metric.compute()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="CLIP score for an image folder + prompt JSON")
    p.add_argument("--folder_path", required=True)
    p.add_argument("--prompts_file", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model", "--model_name_or_path", dest="model",
                   default="openai/clip-vit-base-patch16")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--tiny", action="store_true", help="tiny random-weight CLIP (smoke runs)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    score = calc_clip_score(args.folder_path, args.prompts_file, args.batch_size, args.model,
                            args.image_size, args.tiny, args.device)
    print(f"CLIP score: {score:.4f}")


if __name__ == "__main__":
    main()
