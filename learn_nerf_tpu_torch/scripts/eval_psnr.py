"""Evaluate a trained model: render every view of a dataset and report
PSNR and SSIM (the CLI of ``learn_nerf_tpu.scripts.eval_psnr``).

Prints ``view i: psnr=<dB> dB ssim=<s>`` per view (SSIM over u8 pixels,
Wang et al. 2004; skipped for views under 11 pixels a side), then the
summary lines ``mean_psnr=<dB>`` and ``mean_ssim=<s>`` for scripting.
Renders through :class:`~.render_nerf.RenderSession` with the render
CLI's flags, on the CUDA card unless given ``--device cpu``.

Example:
  python -m learn_nerf_tpu_torch.scripts.eval_psnr --instant_ngp --occupancy \\
      --occ_budget_per_ray auto --model_path ngp.pkl data/test_scene
"""

import os

import numpy as np

from ..data.dataset import load_dataset
from ..utils.metrics import psnr, ssim
from ..utils.progress import progress
from .common import add_device_arg
from .render_nerf import RenderSession, base_argparser


def argparser():
    parser = base_argparser()
    add_device_arg(parser)
    parser.add_argument("--max_views", type=int, default=None, help="evaluate only the first N views")
    parser.add_argument("data_dir", type=str)
    return parser


def main(argv=None):
    """Evaluate as the flags say; returns ``(psnrs, ssims)`` per view."""
    args = argparser().parse_args(argv)
    # RenderSession reads metadata_json: the dataset's own.
    args.metadata_json = os.path.join(args.data_dir, "metadata.json")
    data = load_dataset(args.data_dir)
    views = data.views[: args.max_views] if args.max_views is not None else data.views

    session = RenderSession(args)
    scores, ssims = [], []
    for i, view in enumerate(progress(views, desc="views")):
        gt = view.image()
        pred = session.render_view(view, width=gt.shape[1], height=gt.shape[0])
        session.images.clear()
        score = psnr(pred, gt)
        scores.append(score)
        # SSIM needs an 11-pixel window; tiny views skip it.
        s = ssim(pred, gt) if min(gt.shape[:2]) >= 11 else None
        ssims.append(s)
        extra = f" ssim={s:.4f}" if s is not None else ""
        print(f"view {i}: psnr={score:.2f} dB{extra}", flush=True)

    print(f"mean_psnr={np.mean(scores):.3f}")
    if ssims and all(s is not None for s in ssims):
        print(f"mean_ssim={np.mean(ssims):.4f}")
    return scores, ssims


if __name__ == "__main__":
    main()
