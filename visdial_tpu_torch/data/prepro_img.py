"""Offline image-feature extraction on one GPU (port of
visdial_tpu/data/prepro_img.py, the `data/prepro_img.lua` equivalent).

Runs the port's VGG-16 (models/vgg16.py) over the images of a prepro'd
split, batched, and writes fc7 (and with --save_pool5 pool5, NHWC) features
in the split's dialog order: `images_<split>` (N, 4096) and `pool5_<split>`
(N, 7, 7, 512), the JAX CLI's output.

Image sources, in precedence order:
  * --images_npz FILE: a prebaked (N, 224, 224, 3) RGB uint8 array named
    'images' in dialog order (needs only numpy and torch);
  * --image_root DIR: JPEG/PNG files named by COCO convention, each
    dialog's image_id matched by its 12-digit id (decoded with PIL, short
    side resized to 256, center-cropped to 224, the reference pipeline).

Weights: --weights vgg16.npz in the JAX layout (models/vgg16.py); one file
serves both packages.  Convert a torchvision checkpoint with
`python -c "import torch; from visdial_tpu_torch.models.vgg16 import
convert_torch_state_dict as c; c(torch.load('vgg16.pth'), 'vgg16.npz')"`.
--dtype float32 (the default, TF32 off) or bfloat16.  On the card the
forward is one CUDA graph a batch (parallel/graph.py), captured once: the
tail batch is padded to --batch_size.

Usage:
    python -m visdial_tpu_torch.data.prepro_img --split_npz \\
        data/visdial_data_val.npz --weights vgg16.npz --image_root \\
        coco/val2014 --out data/feats_val.npz [--device cuda | --device cpu]
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
import torch

from ..models import vgg16
from ..parallel.graph import Graphed


def load_and_crop(path: str) -> np.ndarray:
    """Decode, resize the short side to 256, center-crop 224 (RGB uint8)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("--image_root needs Pillow (PIL) to decode images; "
                          "without it, pass the images prebaked with "
                          "--images_npz") from e

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = 256.0 / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    left, top = (w - 224) // 2, (h - 224) // 2
    return np.asarray(img.crop((left, top, left + 224, top + 224)), np.uint8)


def find_image(root: str, image_id: int, index: dict) -> str:
    key = f"{int(image_id):012d}"
    if key not in index:
        raise FileNotFoundError(f"no image file matching *{key}* under {root}")
    return index[key]


def build_file_index(root: str) -> dict:
    """{12-digit id: path} of the files under root, by the last 12 digits
    of each file's stem."""
    index = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            stem = os.path.splitext(f)[0]
            digits = "".join(ch for ch in stem if ch.isdigit())[-12:]
            if digits:
                index[digits.zfill(12)] = os.path.join(dirpath, f)
    return index


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--split_npz", required=True,
                   help="prepro'd split whose img_ids define the order")
    p.add_argument("--weights", required=True, help="vgg16 .npz weights")
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--images_npz", type=str, default="")
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--save_pool5", action="store_true")
    p.add_argument("--preprocess", choices=("auto",) + vgg16.WEIGHT_ORIGINS,
                   default="auto",
                   help="input normalization; 'auto' follows the origin tag "
                        "recorded in the weights file (torchvision weights "
                        "need RGB/255 + ImageNet stats, Caffe weights the "
                        "reference's BGR mean subtraction)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to "
                         "run VGG-16 on the CPU)")
    with np.load(args.split_npz) as z:
        img_ids = np.asarray(z["img_ids"])
    N = len(img_ids)

    origin = (vgg16.weight_origin(args.weights) if args.preprocess == "auto"
              else args.preprocess)
    print(f"preprocessing mode: {origin}", flush=True)
    params = vgg16.load_params(args.weights, getattr(torch, args.dtype), device)

    if args.images_npz:
        with np.load(args.images_npz) as z:
            all_images = np.asarray(z["images"], np.uint8)
        if all_images.shape != (N, 224, 224, 3):
            raise SystemExit(f"--images_npz holds {all_images.shape}, not "
                             f"({N}, 224, 224, 3)")
        get = lambda i: all_images[i]  # noqa: E731
    else:
        if not args.image_root:
            raise SystemExit("need --image_root or --images_npz")
        index = build_file_index(args.image_root)
        get = lambda i: load_and_crop(find_image(args.image_root,  # noqa: E731
                                                 img_ids[i], index))

    bs = args.batch_size
    # the forward as one CUDA graph over the padded batch, as the JAX CLI
    # jits vgg16.apply; the params are closed over, not copied a batch
    forward = Graphed(partial(vgg16.apply, params))
    fc7_out = np.zeros((N, 4096), np.float32)
    pool5_out = np.zeros((N, 7, 7, 512), np.float32) if args.save_pool5 else None
    for s in range(0, N, bs):
        idx = range(s, min(s + bs, N))
        raw = np.stack([get(i) for i in idx])
        batch = vgg16.preprocess(raw, origin=origin)
        if len(idx) < bs:  # one batch shape: pad the tail batch
            batch = np.pad(batch, ((0, bs - len(idx)), (0, 0), (0, 0), (0, 0)))
        x = torch.from_numpy(batch)
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        feats = forward(x)
        fc7_out[idx] = feats["fc7"][: len(idx)].cpu().numpy()
        if pool5_out is not None:
            pool5_out[idx] = feats["pool5"][: len(idx)].float().cpu().numpy()
        if (s // bs) % 20 == 0:
            print(f"{s + len(idx)}/{N}", flush=True)

    split = os.path.basename(args.split_npz)
    split = "val" if "val" in split else "train"
    out = {f"images_{split}": fc7_out}
    if pool5_out is not None:
        out[f"pool5_{split}"] = pool5_out
    np.savez(args.out, **out)
    print(f"wrote {args.out}: fc7 {fc7_out.shape}"
          + (f", pool5 {pool5_out.shape}" if pool5_out is not None else ""),
          flush=True)
    return out


if __name__ == "__main__":
    main()
