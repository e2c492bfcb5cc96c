"""One-off generation with the PyTorch/CUDA port:

    python -m sonicdiffusionbayeslab_torch.generate --prompt "a lighthouse at dusk" --steps 20
    python -m sonicdiffusionbayeslab_torch.generate --prompt "..." --tiny --device cpu
    python -m sonicdiffusionbayeslab_torch.generate --prompt "..." --init_image in.png \
        --strength 0.8 [--mask_image mask.png]

Runs SD-1.5 (bf16, random weights from seed 0, or a local diffusers
snapshot named by ``--pretrained_model``) with 20-step DPM-Solver++ by
default (``--scheduler`` picks another ported scheduler by its registry
name; ``--variant sd21`` SD-2.x) and writes one PNG per prompt.
``--init_image`` makes it img2img from that image (read at
``--image_size``, 16 for ``--tiny``), ``--mask_image`` inpainting (white =
regenerate: the mask is the image's channel mean > 0.5);
``--cache_interval`` > 0 turns DeepCache on, ``--prompt_weighting`` the
``(word:1.3)`` emphasis syntax.
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
    p.add_argument("--cache_interval", type=int, default=0, help="DeepCache interval (0 = off)")
    p.add_argument("--cache_branch_id", type=int, default=0, help="DeepCache split depth")
    p.add_argument("--init_image", default=None, help="img2img source image path")
    p.add_argument("--strength", type=float, default=0.8, help="img2img noising strength")
    p.add_argument("--mask_image", default=None,
                   help="inpainting mask path (white = regenerate); needs --init_image")
    p.add_argument("--prompt_weighting", action="store_true",
                   help="parse (word:1.3) / (word) / [word] emphasis in the prompts")
    args = p.parse_args(argv)

    import numpy as np

    from sonicdiffusionbayeslab_torch.data.imageio import read_image, write_png
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, schedulers_registry

    load_all_plugins()
    if args.scheduler not in schedulers_registry:
        raise ValueError(f"scheduler {args.scheduler!r} is not ported; ported: "
                         f"{', '.join(sorted(schedulers_registry.keys()))}")
    if getattr(schedulers_registry[args.scheduler], "SPACE", "vp") == "flow":
        raise ValueError(f"scheduler {args.scheduler!r} samples flow-matching models (SD3): SD3 "
                         "through generate.py is not ported yet; use the pipeline "
                         "stable_diffusion_3_model or the experiment CLI")
    skw = {"solver_order": args.solver_order} if args.scheduler == "dpm_solver_scheduler" else {}
    skw.update(json.loads(args.scheduler_kwargs))
    model = StableDiffusionModel(pretrained_model=args.pretrained_model,
                                 image_size=args.image_size, tiny=args.tiny,
                                 variant=args.variant, device=args.device,
                                 prompt_weighting=args.prompt_weighting)
    model.scheduler = schedulers_registry[args.scheduler](**skw)
    if args.cache_interval > 0:
        model.cache_plan_fn = lambda n: CachePlan.every(n, args.cache_interval,
                                                        args.cache_branch_id)
    call_kw = {}
    if args.init_image:
        size = 16 if args.tiny else args.image_size
        img = read_image(args.init_image, image_size=size)
        call_kw.update(init_image=np.repeat(img[None], len(args.prompt), axis=0),
                       strength=args.strength)
        if args.mask_image:
            m = read_image(args.mask_image, image_size=size).mean(axis=-1, keepdims=True)
            call_kw["mask_image"] = np.repeat((m > 0.5).astype(np.float32)[None],
                                              len(args.prompt), axis=0)
    elif args.mask_image:
        raise ValueError("--mask_image needs --init_image")
    images, exec_time, _ = model(
        args.prompt,
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        negative_prompt=[args.negative_prompt] * len(args.prompt),
        seed=args.seed,
        height=args.height,
        width=args.width,
        **call_kw,
    )
    for i, img in enumerate(images):
        path = args.out.format(i=i)
        write_png(path, img)
        print(f"wrote {path}")
    print(f"denoise loop: {exec_time:.3f}s for {len(images)} image(s) "
          f"({exec_time / len(images):.3f} s/img) on {model.device}")


if __name__ == "__main__":
    main()
