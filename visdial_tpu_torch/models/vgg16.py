"""VGG-16 forward in PyTorch, the image-feature extractor (port of
visdial_tpu/models/vgg16.py; reference: data/prepro_img.lua's VGG-16,
224 x 224 center crop, fc7 4096-d features).

A set of functions over a params dict, as in the JAX package (no nn.Module,
no torchvision): init_params, load_params / save_params, apply, plus the
preprocessing keyed by the weights' origin and the torchvision converter.

The weights file is the contract between the two packages: an .npz with
'<layer>/w' and '<layer>/b' in the JAX layout -- HWIO convolutions, fc
weights (in, out), and fc6's input rows in NHWC-flattened order -- so one
vgg16.npz serves both.  load_params turns that layout, once, into the
torch one held here: OIHW convolutions and fc weights (out, in) with fc6's
input columns in NCHW-flattened order, so the network runs NCHW and
flattens pool5 as torch does, and still computes the JAX net's fc6.

Feature taps: fc7 (N, 4096) float32, the ReLU'd fc7 activations; pool5
(N, 7, 7, 512) NHWC, conv5_3 after pooling, as the JAX net returns it.

The convolutions and pooling are cuDNN's (F.conv2d, F.max_pool2d) and the
fc layers plain matmuls: the JAX package computes them with XLA's
convolution and reduce_window outside any Pallas kernel.  Precision is the
params' dtype: float32 runs with TF32 off (exact f32 products), bfloat16
with f32 accumulation and bf16 activations.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# (name, out_channels) per conv layer; 'M' = 2x2/2 max-pool.
_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M",
]
CONV_NAMES = [c[0] for c in _CFG if c != "M"]
FC_NAMES = ["fc6", "fc7"]
# torchvision's vgg16 state_dict indices of the convolutions
_TORCH_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

# Caffe-era BGR channel means of the reference's prepro
BGR_MEANS = (103.939, 116.779, 123.68)
# torchvision-era normalization: RGB scaled to [0, 1], ImageNet mean/std.
# VGG-16 weights give in-distribution features only under the
# preprocessing they were trained with, so the weights file records its
# origin and `preprocess` is keyed by it.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
WEIGHT_ORIGINS = ("caffe", "torchvision")


def init_params(gen: torch.Generator, he: bool = False,
                dtype=torch.float32, device="cpu") -> dict:
    """Random VGG-16 weights from a CPU generator, in the torch layout.
    Default: N(0, 0.01^2) as the JAX init_params (testing only: thirteen
    such convolutions shrink the activations to ~0); he=True draws
    N(0, 2 / fan_in), which keeps them alive through the net."""
    def draw(shape, fan_in):
        std = (2.0 / fan_in) ** 0.5 if he else 0.01
        return torch.randn(shape, generator=gen) * std

    params, in_ch = {}, 3
    for item in _CFG:
        if item == "M":
            continue
        name, out_ch = item
        params[name] = {"w": draw((out_ch, in_ch, 3, 3), 9 * in_ch),
                        "b": torch.zeros(out_ch)}
        in_ch = out_ch
    for name, (d_in, d_out) in zip(FC_NAMES, [(7 * 7 * 512, 4096),
                                              (4096, 4096)]):
        params[name] = {"w": draw((d_out, d_in), d_in), "b": torch.zeros(d_out)}
    return {k: {kk: v.to(device, dtype) for kk, v in d.items()}
            for k, d in params.items()}


def _fc6_rows_nhwc_to_nchw(w_in_out: np.ndarray) -> np.ndarray:
    """fc6 (25088, out) with input rows in NHWC-flattened order -> (out,
    25088) with input columns in NCHW-flattened order."""
    out = w_in_out.shape[1]
    return (w_in_out.reshape(7, 7, 512, out).transpose(3, 2, 0, 1)
            .reshape(out, -1))


def load_params(path: str, dtype=torch.float32, device="cpu") -> dict:
    """Weights from an .npz in the JAX layout (conv w (3, 3, in, out) HWIO,
    fc w (in, out), fc6's rows NHWC-flattened) -> the torch layout."""
    params = {}
    with np.load(path) as z:
        for name in CONV_NAMES + FC_NAMES:
            w = np.asarray(z[f"{name}/w"], np.float32)
            if name == "fc6":
                w = _fc6_rows_nhwc_to_nchw(w)
            elif name in FC_NAMES:
                w = w.T
            else:
                w = w.transpose(3, 2, 0, 1)                     # OIHW
            params[name] = {
                "w": torch.from_numpy(np.ascontiguousarray(w)),
                "b": torch.from_numpy(np.asarray(z[f"{name}/b"], np.float32))}
    return {k: {kk: v.to(device, dtype) for kk, v in d.items()}
            for k, d in params.items()}


def state_dict(params: dict) -> dict:
    """The params as a torchvision vgg16 state_dict (numpy arrays, f32)."""
    sd = {}
    for name, idx in zip(CONV_NAMES, _TORCH_CONV_IDS):
        sd[f"features.{idx}.weight"] = params[name]["w"]
        sd[f"features.{idx}.bias"] = params[name]["b"]
    for name, idx in zip(FC_NAMES, (0, 3)):
        sd[f"classifier.{idx}.weight"] = params[name]["w"]
        sd[f"classifier.{idx}.bias"] = params[name]["b"]
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in sd.items()}


def save_params(params: dict, path: str, origin: str = "torchvision") -> None:
    """Write params as the JAX-layout .npz load_params reads, tagged with
    the preprocessing origin."""
    convert_torch_state_dict(state_dict(params), path, origin=origin)


def convert_torch_state_dict(state_dict, out_path: str,
                             origin: str = "torchvision") -> None:
    """A torchvision vgg16 state_dict -> the .npz layout of load_params
    (vgg16.py::convert_torch_state_dict): OIHW -> HWIO convolutions, fc
    weights transposed, fc6's input reordered from NCHW- to NHWC-flattened,
    and the origin recorded for `preprocess`."""
    if origin not in WEIGHT_ORIGINS:
        raise ValueError(f"unknown weight origin {origin!r}; choose from "
                         f"{WEIGHT_ORIGINS}")
    out = {"origin": np.asarray(origin)}
    for name, idx in zip(CONV_NAMES, _TORCH_CONV_IDS):
        w = np.asarray(state_dict[f"features.{idx}.weight"])   # (O, I, H, W)
        out[f"{name}/w"] = w.transpose(2, 3, 1, 0)              # HWIO
        out[f"{name}/b"] = np.asarray(state_dict[f"features.{idx}.bias"])
    for name, idx in zip(FC_NAMES, (0, 3)):
        w = np.asarray(state_dict[f"classifier.{idx}.weight"])  # (out, in)
        if name == "fc6":  # torch flattens NCHW (512, 7, 7); the npz NHWC
            w = w.reshape(-1, 512, 7, 7).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
        out[f"{name}/w"] = w.T
        out[f"{name}/b"] = np.asarray(state_dict[f"classifier.{idx}.bias"])
    np.savez(out_path, **out)


def weight_origin(path: str) -> str:
    """The preprocessing origin recorded in a weights .npz; files written
    before the tag existed (or converted from Caffe VGG-16, the reference's
    source) default to 'caffe'."""
    with np.load(path) as z:
        if "origin" in z.files:
            return str(z["origin"])
    return "caffe"


def preprocess(images_rgb_uint8: np.ndarray, origin: str = "caffe") -> np.ndarray:
    """(N, 224, 224, 3) RGB uint8 -> float32 normalized for `origin` weights.
    caffe (the reference pipeline): RGB -> BGR, 0-255 scale, per-channel
    mean subtraction; torchvision: RGB / 255, ImageNet mean/std."""
    if origin == "caffe":
        x = np.asarray(images_rgb_uint8, np.float32)[..., ::-1]  # RGB -> BGR
        return x - np.asarray(BGR_MEANS, np.float32)
    if origin == "torchvision":
        x = np.asarray(images_rgb_uint8, np.float32) / 255.0
        return ((x - np.asarray(IMAGENET_MEAN, np.float32))
                / np.asarray(IMAGENET_STD, np.float32))
    raise ValueError(f"unknown weight origin {origin!r}; "
                     f"choose from {WEIGHT_ORIGINS}")


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions and matmuls in exact f32 (TF32 off), restored
    after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def apply(params: dict, images: torch.Tensor) -> dict:
    """images (N, 224, 224, 3) preprocessed, NHWC as the JAX net takes them
    -> {'fc7': (N, 4096) float32, 'pool5': (N, 7, 7, 512) NHWC in the
    params' dtype}.  Computes in the params' dtype (float32 with TF32 off)."""
    dtype = params["conv1_1"]["w"].dtype
    with _no_tf32(), torch.inference_mode():
        x = images.to(dtype).permute(0, 3, 1, 2)               # NCHW
        for item in _CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                p = params[item[0]]
                x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
        # the fc layers take their inputs in the dtype and sum in f32, as
        # the JAX net's dots with preferred_element_type=float32
        fc6 = _linear_f32(x.flatten(1), params["fc6"])   # NCHW flatten order
        fc7 = _linear_f32(fc6.to(dtype), params["fc7"])
        return {"fc7": fc7, "pool5": x.permute(0, 2, 3, 1).contiguous()}


def _linear_f32(x: torch.Tensor, p: dict) -> torch.Tensor:
    """relu(x W^T + b) in float32 from x and W as they are."""
    return F.relu(x.float() @ p["w"].float().T + p["b"].float())
