"""One-off text-to-image generation with the PyTorch/CUDA port:

    python -m sonicdiffusionbayeslab_torch.generate --prompt "a lighthouse at dusk" --steps 20
    python -m sonicdiffusionbayeslab_torch.generate --prompt "..." --tiny --device cpu

Runs SD-1.5 (bf16, random weights from seed 0, or a local diffusers
snapshot named by ``--pretrained_model``) with 20-step DPM-Solver++ by
default (``--scheduler`` picks another ported scheduler by its registry
name; ``--variant sd21`` SD-2.x) and writes one PNG per prompt.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Generate images with the PyTorch/CUDA SD pipeline")
    p.add_argument("--prompt", action="append", required=True,
                   help="repeatable; one image per prompt")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--scheduler", default="dpm_solver_scheduler",
                   help="a ported schedulers_registry name")
    p.add_argument("--solver_order", type=int, default=2)
    p.add_argument("--scheduler_kwargs", default="{}",
                   help='JSON, e.g. \'{"use_karras_sigmas": true}\'')
    p.add_argument("--seed", type=int, default=29, help="initial-noise seed")
    p.add_argument("--pretrained_model", default="runwayml/stable-diffusion-v1-5",
                   help="a local diffusers snapshot, or a model id (random weights)")
    p.add_argument("--variant", default="auto", help="sd15 | sd21 | auto")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--height", type=int, default=None, help="non-square height (multiple of 8)")
    p.add_argument("--width", type=int, default=None, help="non-square width (multiple of 8)")
    p.add_argument("--out", default="outputs/generate_torch/img_{i:03d}.png")
    p.add_argument("--tiny", action="store_true", help="tiny random-weight model (smoke)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from sonicdiffusionbayeslab_torch.data.imageio import write_png
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, schedulers_registry

    load_all_plugins()
    if args.scheduler not in schedulers_registry:
        raise ValueError(f"scheduler {args.scheduler!r} is not ported; ported: "
                         f"{', '.join(sorted(schedulers_registry.keys()))}")
    skw = {"solver_order": args.solver_order} if args.scheduler == "dpm_solver_scheduler" else {}
    skw.update(json.loads(args.scheduler_kwargs))
    model = StableDiffusionModel(pretrained_model=args.pretrained_model,
                                 image_size=args.image_size, tiny=args.tiny,
                                 variant=args.variant, device=args.device)
    model.scheduler = schedulers_registry[args.scheduler](**skw)
    images, exec_time, _ = model(
        args.prompt,
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        negative_prompt=[args.negative_prompt] * len(args.prompt),
        seed=args.seed,
        height=args.height,
        width=args.width,
    )
    for i, img in enumerate(images):
        path = args.out.format(i=i)
        write_png(path, img)
        print(f"wrote {path}")
    print(f"denoise loop: {exec_time:.3f}s for {len(images)} image(s) "
          f"({exec_time / len(images):.3f} s/img) on {model.device}")


if __name__ == "__main__":
    main()
