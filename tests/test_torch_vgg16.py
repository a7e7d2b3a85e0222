"""The port's VGG-16 (visdial_tpu_torch/models/vgg16.py) and its prepro_img
CLI against the JAX package's, on the CPU in f32: one weights .npz in the
JAX layout read by both, He-scaled so that the features are alive (the
0.01-std init shrinks them to ~0 and any comparison would pass).  fc7 and
pool5 (NHWC) are held to rtol 1e-4 with atol 1e-4 of the largest value:
both sides sum the same f32 products in another order over 13 convolutions
and two fc layers."""

import numpy as np
import pytest
import torch

from visdial_tpu.data import prepro_img as jax_prepro_img
from visdial_tpu.models import vgg16 as jax_vgg16
from visdial_tpu_torch.data import prepro_img
from visdial_tpu_torch.models import vgg16

from test_vgg16 import _fake_torch_state_dict

torch.set_num_threads(1)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """He-scaled weights from a seed, written in the JAX layout."""
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.npz")
    vgg16.save_params(vgg16.init_params(torch.Generator().manual_seed(0),
                                        he=True), path)
    return path


def test_apply_matches_jax(weights):
    imgs = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3),
                                             dtype=np.uint8)
    x = vgg16.preprocess(imgs, origin="torchvision")
    want = jax_vgg16.apply(jax_vgg16.load_params(weights), x)
    got = vgg16.apply(vgg16.load_params(weights), torch.from_numpy(x))
    assert got["pool5"].shape == (2, 7, 7, 512)
    assert got["fc7"].dtype == torch.float32
    _close(got["pool5"], want["pool5"])
    _close(got["fc7"], want["fc7"])
    fc7 = np.asarray(want["fc7"])
    assert (fc7 > 0).mean() > 0.2 and np.abs(fc7).max() > 1e-2


def test_default_init_keeps_the_jax_scale():
    params = vgg16.init_params(torch.Generator().manual_seed(0))
    assert float(params["conv1_1"]["w"].std()) == pytest.approx(0.01, rel=0.1)
    assert tuple(params["fc6"]["w"].shape) == (4096, 7 * 7 * 512)
    assert tuple(params["conv5_3"]["w"].shape) == (512, 512, 3, 3)


def test_converted_state_dict_npz_equals_jax(tmp_path):
    sd = _fake_torch_state_dict(np.random.default_rng(0))
    vgg16.convert_torch_state_dict(sd, str(tmp_path / "port.npz"))
    jax_vgg16.convert_torch_state_dict(sd, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert vgg16.weight_origin(str(tmp_path / "port.npz")) == "torchvision"
    with pytest.raises(ValueError, match="origin"):
        vgg16.convert_torch_state_dict(sd, str(tmp_path / "x.npz"),
                                       origin="vgg-face")


def test_save_and_load_round_trip_the_layout(tmp_path):
    first = str(tmp_path / "first.npz")
    vgg16.convert_torch_state_dict(
        _fake_torch_state_dict(np.random.default_rng(5)), first)
    again = str(tmp_path / "again.npz")
    vgg16.save_params(vgg16.load_params(first), again)
    with np.load(first) as a, np.load(again) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("origin", ["caffe", "torchvision"])
def test_preprocess_matches_jax(origin):
    imgs = np.random.default_rng(2).integers(0, 256, (2, 5, 4, 3),
                                             dtype=np.uint8)
    got = vgg16.preprocess(imgs, origin=origin)
    want = jax_vgg16.preprocess(imgs, origin=origin)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        vgg16.preprocess(imgs, origin="vgg-face")


def test_untagged_weights_default_to_caffe(tmp_path):
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **{"conv1_1/w": np.zeros((3, 3, 3, 64), np.float32)})
    assert vgg16.weight_origin(path) == "caffe"
    assert jax_vgg16.weight_origin(path) == "caffe"


def test_prepro_img_cli_matches_jax(weights, tmp_path):
    """3 images at batch 2 (the tail batch pads), --save_pool5: the same
    keys, shapes and features as the JAX CLI's file."""
    n = 3
    split = str(tmp_path / "visdial_data_val.npz")
    np.savez(split, img_ids=np.arange(100, 100 + n))
    images = str(tmp_path / "images.npz")
    np.savez(images, images=np.random.default_rng(3).integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8))
    argv = ["--split_npz", split, "--weights", weights, "--images_npz", images,
            "--batch_size", "2", "--save_pool5"]
    prepro_img.main(argv + ["--out", str(tmp_path / "port.npz"),
                            "--device", "cpu"])
    jax_prepro_img.main(argv + ["--out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["images_val", "pool5_val"]
        assert a["images_val"].shape == (n, 4096)
        assert a["pool5_val"].shape == (n, 7, 7, 512)
        for k in b.files:
            _close(a[k], b[k])


def test_load_and_crop_matches_jax(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(4).integers(0, 256, (260, 300, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "COCO_val2014_000000000042.png")
    Image.fromarray(rgb).save(path)
    got = prepro_img.load_and_crop(path)
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_prepro_img.load_and_crop(path))
    index = prepro_img.build_file_index(str(tmp_path))
    assert index == jax_prepro_img.build_file_index(str(tmp_path))
    assert prepro_img.find_image(str(tmp_path), 42, index) == path
    with pytest.raises(FileNotFoundError):
        prepro_img.find_image(str(tmp_path), 43, index)
