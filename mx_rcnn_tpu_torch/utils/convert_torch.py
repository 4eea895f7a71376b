"""torchvision ImageNet checkpoints → the flat ``.npz`` layout that
``--pretrained`` reads (the port's own copy of
``mx_rcnn_tpu/utils/convert_torch.py``; numpy and, for the file's
``torch.load``, torch — torchvision is not needed)::

    python -m mx_rcnn_tpu_torch.utils.convert_torch resnet101.pth \
        resnet101 model/resnet101.npz
    python -m mx_rcnn_tpu_torch.train_end2end ... \
        --pretrained model/resnet101.npz

``tools/common.py:init_or_load_params`` lays each leaf over the seeded
random weights by key and shape.  Name maps (torchvision → the JAX flat
keys under ``backbone``/``head_body``):

ResNet:  conv1→backbone/conv1, bn1→backbone/bn1,
         layer{1..3}.{u}.*→backbone/stage{1..3}/unit{u+1}/*,
         layer4.{u}.*→head_body/stage4/unit{u+1}/*,
         convN/downsample.0→convN/sc_conv (OIHW→HWIO),
         bnN/downsample.1→{gamma,beta,mean,var}.
VGG16:   features.{idx}→backbone/conv{b}_{i} (the 13 convs in order),
         classifier.{0,3}→head_body/{fc6,fc7} (fc weights transposed, fc6's
         input axis in HWC order), the keys of the port's
         ``models/backbones.py:VGGConv`` and ``VGGFC``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mx_rcnn_tpu_torch.train.checkpoint import save_params_npz

RESNET_UNITS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                "resnet152": (3, 8, 36, 3)}

# torchvision vgg16 features indices of the 13 convs, in block order
_VGG_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_VGG_NAMES = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
              "conv3_2", "conv3_3", "conv4_1", "conv4_2", "conv4_3",
              "conv5_1", "conv5_2", "conv5_3"]


def _conv(w: np.ndarray) -> np.ndarray:
    """OIHW → HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _bn(prefix: str, sd: Dict) -> Dict[str, np.ndarray]:
    return {
        "gamma": np.asarray(sd[prefix + ".weight"]),
        "beta": np.asarray(sd[prefix + ".bias"]),
        "mean": np.asarray(sd[prefix + ".running_mean"]),
        "var": np.asarray(sd[prefix + ".running_var"]),
    }


def convert_resnet(sd: Dict, depth: str = "resnet50") -> Dict[str, np.ndarray]:
    """torchvision resnet state_dict → flat {path: array} for
    save_params_npz's layout (backbone stages 1-3 + head_body stage4)."""
    out: Dict[str, np.ndarray] = {}

    def put(path: str, arr: np.ndarray):
        out[path] = np.asarray(arr)

    put("backbone/conv1/kernel", _conv(sd["conv1.weight"]))
    for k, v in _bn("bn1", sd).items():
        put(f"backbone/bn1/{k}", v)

    units = RESNET_UNITS[depth]
    for li, n in enumerate(units, start=1):
        scope = f"backbone/stage{li}" if li <= 3 else "head_body/stage4"
        for u in range(n):
            src = f"layer{li}.{u}"
            dst = f"{scope}/unit{u + 1}"
            for c in (1, 2, 3):
                put(f"{dst}/conv{c}/kernel", _conv(sd[f"{src}.conv{c}.weight"]))
                for k, v in _bn(f"{src}.bn{c}", sd).items():
                    put(f"{dst}/bn{c}/{k}", v)
            if f"{src}.downsample.0.weight" in sd:
                put(f"{dst}/sc_conv/kernel",
                    _conv(sd[f"{src}.downsample.0.weight"]))
                for k, v in _bn(f"{src}.downsample.1", sd).items():
                    put(f"{dst}/sc_bn/{k}", v)
    return out


def convert_vgg16(sd: Dict) -> Dict[str, np.ndarray]:
    """torchvision vgg16 state_dict → the flat dict (13 convs, fc6, fc7)."""
    out: Dict[str, np.ndarray] = {}
    for idx, name in zip(_VGG_CONV_IDX, _VGG_NAMES):
        out[f"backbone/{name}/kernel"] = _conv(sd[f"features.{idx}.weight"])
        out[f"backbone/{name}/bias"] = np.asarray(sd[f"features.{idx}.bias"])
    # classifier.0 = fc6 (25088→4096).  torch flattens pooled features in
    # CHW order, our VGGFC flattens HWC — permute the input axis to match.
    w6 = np.asarray(sd["classifier.0.weight"])          # (4096, 512*7*7)
    w6 = w6.reshape(4096, 512, 7, 7).transpose(2, 3, 1, 0).reshape(-1, 4096)
    out["head_body/fc6/kernel"] = w6
    out["head_body/fc6/bias"] = np.asarray(sd["classifier.0.bias"])
    out["head_body/fc7/kernel"] = np.asarray(sd["classifier.3.weight"]).T
    out["head_body/fc7/bias"] = np.asarray(sd["classifier.3.bias"])
    return out


def convert(state_dict: Dict, network: str) -> Dict[str, np.ndarray]:
    """A torchvision state_dict (numpy values) of ``network`` → the flat
    dict."""
    if network in RESNET_UNITS:
        return convert_resnet(state_dict, network)
    if network == "vgg16":
        return convert_vgg16(state_dict)
    raise KeyError(network)


def convert_file(pth_path: str, network: str, npz_path: str) -> None:
    """The command line's work: a torch ``.pth`` (a state_dict, or a module
    with one) → the flat ``.npz``."""
    import torch

    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    flat = convert({k: v.numpy() for k, v in sd.items()}, network)
    if not npz_path.endswith(".npz"):  # np.savez's naming
        npz_path += ".npz"
    save_params_npz(npz_path, flat)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="torchvision .pth -> the flat "
                                 ".npz that --pretrained reads")
    ap.add_argument("pth")
    ap.add_argument("network", choices=sorted(RESNET_UNITS) + ["vgg16"])
    ap.add_argument("npz")
    a = ap.parse_args()
    convert_file(a.pth, a.network, a.npz)
