"""The port's torchvision converter (``utils/convert_torch.py``) against the
JAX package's (``mx_rcnn_tpu/utils/convert_torch.py``), on the CPU.

State dicts with torchvision's names and shapes (``resnet{50,101,152}``
with their ``fc`` and ``num_batches_tracked`` entries, ``vgg16``) and
seeded random values, built here (torchvision is not needed): the port's
``convert`` gives the JAX ``convert``'s output key for key, bitwise.  The
ResNet outputs cover every ``backbone`` and ``head_body`` leaf of the
port's model at its shape; ``convert_file``'s ``.npz`` (and the module's
command line) holds the same arrays; ``--pretrained`` of it lays every
one of those leaves over the seeded weights and leaves the heads alone.

Tolerances: none; every comparison is exact.
"""

import argparse
import runpy
import sys
import warnings

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.utils import convert_torch as j_convert_torch

from mx_rcnn_tpu_torch.config import generate_config
from mx_rcnn_tpu_torch.models import backbones
from mx_rcnn_tpu_torch.models.detector import build_model
from mx_rcnn_tpu_torch.tools.common import init_or_load_params
from mx_rcnn_tpu_torch.train.checkpoint import load_params_npz
from mx_rcnn_tpu_torch.utils import convert_torch
from mx_rcnn_tpu_torch.utils.convert_jax import param_shapes, random_params

def _randn(rng, *shape):
    return rng.random(shape, dtype=np.float32) * 2 - 1


def resnet_state_dict(depth, seed=0):
    """torchvision ``resnet{50,101,152}``'s keys and shapes."""
    rng = np.random.default_rng(seed)
    sd = {}

    def bn(prefix, c):
        sd[prefix + ".weight"] = _randn(rng, c)
        sd[prefix + ".bias"] = _randn(rng, c)
        sd[prefix + ".running_mean"] = _randn(rng, c)
        sd[prefix + ".running_var"] = _randn(rng, c) + 1.5
        sd[prefix + ".num_batches_tracked"] = np.asarray(7, np.int64)

    sd["conv1.weight"] = _randn(rng, 64, 3, 7, 7)
    bn("bn1", 64)
    in_ch = 64
    for li, (n, w) in enumerate(zip(convert_torch.RESNET_UNITS[depth],
                                    (64, 128, 256, 512)), start=1):
        for u in range(n):
            p = f"layer{li}.{u}"
            c_in = in_ch if u == 0 else w * 4
            sd[p + ".conv1.weight"] = _randn(rng, w, c_in, 1, 1)
            bn(p + ".bn1", w)
            sd[p + ".conv2.weight"] = _randn(rng, w, w, 3, 3)
            bn(p + ".bn2", w)
            sd[p + ".conv3.weight"] = _randn(rng, w * 4, w, 1, 1)
            bn(p + ".bn3", w * 4)
            if u == 0:
                sd[p + ".downsample.0.weight"] = _randn(rng, w * 4, c_in, 1,
                                                        1)
                bn(p + ".downsample.1", w * 4)
        in_ch = w * 4
    sd["fc.weight"] = _randn(rng, 1000, 2048)
    sd["fc.bias"] = _randn(rng, 1000)
    return sd


def vgg16_state_dict(seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    chans = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256),
             (256, 256), (512, 256), (512, 512), (512, 512), (512, 512),
             (512, 512), (512, 512)]
    for idx, (o, i) in zip(convert_torch._VGG_CONV_IDX, chans):
        sd[f"features.{idx}.weight"] = _randn(rng, o, i, 3, 3)
        sd[f"features.{idx}.bias"] = _randn(rng, o)
    for idx, (o, i) in ((0, (4096, 25088)), (3, (4096, 4096)),
                        (6, (1000, 4096))):
        sd[f"classifier.{idx}.weight"] = _randn(rng, o, i)
        sd[f"classifier.{idx}.bias"] = _randn(rng, o)
    return sd


def assert_same(got, want):
    """Key for key, the same dtype, shape and bytes."""
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype,
                                                want[k].shape), k
        assert np.ascontiguousarray(got[k]).tobytes() == \
            np.ascontiguousarray(want[k]).tobytes(), k


def covered_keys(network):
    """Every ``backbone`` and ``head_body`` key of the port's model with its
    shape."""
    shapes = param_shapes(build_model(generate_config(network, "PascalVOC")))
    return {k: s for k, s in shapes.items()
            if k.startswith(("backbone/", "head_body/"))}


@pytest.mark.parametrize("depth", ["resnet50", "resnet101", "resnet152"])
def test_resnet_matches_jax_and_covers_the_model(depth):
    sd = resnet_state_dict(depth)
    got = convert_torch.convert(sd, depth)
    assert_same(got, j_convert_torch.convert(sd, depth))
    want = covered_keys(depth)
    assert got.keys() == want.keys()
    for k, s in want.items():
        assert got[k].shape == tuple(s), k


def test_vgg16_matches_jax():
    sd = vgg16_state_dict()
    assert_same(convert_torch.convert(sd, "vgg16"),
                j_convert_torch.convert(sd, "vgg16"))
    with pytest.raises(KeyError):
        convert_torch.convert(sd, "vgg19")


def test_tables_agree():
    assert convert_torch.RESNET_UNITS == j_convert_torch.RESNET_UNITS == \
        backbones.RESNET_UNITS
    assert convert_torch._VGG_CONV_IDX == j_convert_torch._VGG_CONV_IDX


def test_file_and_pretrained(tmp_path, monkeypatch):
    """A ``.pth`` of torch tensors → ``convert_file`` (and ``python -m``)
    → ``--pretrained``: every backbone and ``head_body`` leaf is the
    converted one, every other leaf the seeded one."""
    sd = resnet_state_dict("resnet50", seed=3)
    pth = tmp_path / "resnet50.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pth)
    want = j_convert_torch.convert(sd, "resnet50")
    convert_torch.convert_file(str(pth), "resnet50", str(tmp_path / "a.npz"))
    assert_same(load_params_npz(str(tmp_path / "a.npz")), want)
    # the command line, run as ``python -m`` runs it
    monkeypatch.setattr(sys, "argv", ["convert_torch", str(pth), "resnet50",
                                      str(tmp_path / "b")])
    with warnings.catch_warnings():  # the module is already imported
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module("mx_rcnn_tpu_torch.utils.convert_torch",
                         run_name="__main__")
    assert_same(load_params_npz(str(tmp_path / "b.npz")), want)

    model = build_model(generate_config("resnet50", "PascalVOC"))
    args = argparse.Namespace(seed=5, pretrained=str(tmp_path / "a.npz"))
    got = init_or_load_params(args, model)
    seeded = random_params(model, seed=5)
    laid = covered_keys("resnet50")
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k] if k in laid else seeded[k],
                                      err_msg=k)
    assert len(laid) == len(want) and len(got) > len(laid)
