"""The PyTorch port stands alone: it imports without JAX and without the
JAX package, no file of it names ``jax``, ``flax``, ``orbax``, ``cv2``,
``pycocotools`` or ``mx_rcnn_tpu``, PIL is imported only inside ``get_image``'s JPEG branch,
and its entry points (``Predictor``, ``fit``, ``train_end2end``, ``test``,
``serve``, ``train_alternate`` and its stage tools, also at ``--network
vgg16``) never fall back to the CPU when asked for the card.  Plus the
one test that needs the card (``cuda`` marker): the NMS kernels against their plain versions, and
a chain cut inside a 64-row block.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import mx_rcnn_tpu_torch
from mx_rcnn_tpu_torch.eval.tester import Predictor, resolve_device

torch.set_num_threads(2)

PKG = pathlib.Path(mx_rcnn_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "flax", "orbax", "cv2", "pycocotools", "mx_rcnn_tpu")


def port_modules():
    return sorted(
        ".".join(("mx_rcnn_tpu_torch",) + p.relative_to(PKG).with_suffix(
            "").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_imports_with_jax_and_the_jax_package_blocked():
    mods = port_modules()
    for mod in ("kernels.nms_cuda", "kernels.assign_cuda", "ops.assign_anchor",
                "ops.sample_rois", "data.loader", "data.workers",
                "train.trainer",
                "train_end2end", "data.pascal_voc", "eval.voc_eval",
                "eval.pipeline", "tools.common", "tools.reeval", "test",
                "telemetry", "telemetry.sink", "telemetry.tracectx",
                "telemetry.obs", "compile", "compile.registry", "serve",
                "serve.engine", "serve.warmup", "serve.frontend",
                "serve.controller", "serve.driver", "serve.__main__",
                "train_alternate", "tools.train_rpn", "tools.test_rpn",
                "tools.train_rcnn", "utils.combine_model",
                "utils.load_data", "train.resilience", "train.checkpoint",
                "train.optim", "train.train_step", "utils.convert_torch",
                "models.fpn", "native", "eval.mask_rle", "ops.mask_paste",
                "eval.coco_eval", "data.coco_dataset", "data.mask",
                "ops.mask_target", "models.backbones", "models.detector"):
        assert f"mx_rcnn_tpu_torch.{mod}" in mods
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "import importlib\n"
            + f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_port_file_imports_forbidden_modules():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_pil_is_imported_only_in_the_jpeg_branch():
    """The card's Python may have no PIL: no module imports it at load
    time, and the one import sits in ``data/image.py:get_image``."""
    found = []
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        funcs = [f for f in ast.walk(tree)
                 if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            if any(n.split(".")[0] == "PIL" for n in names):
                owner = [f.name for f in funcs
                         if f.lineno <= node.lineno <= f.end_lineno]
                found.append((path.relative_to(PKG).as_posix(), owner))
    assert found == [("data/image.py", ["get_image"])]


def test_predictor_without_a_device_raises_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(None, {}, None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_end2end_without_a_card_raises(monkeypatch, tmp_path):
    from mx_rcnn_tpu_torch import train_end2end
    from mx_rcnn_tpu_torch.train.trainer import fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_end2end.parse_args(["--synthetic", "--prefix",
                                     str(tmp_path / "e2e")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_end2end.train_net(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(None, None, {}, None)
    # resuming, and the fault-tolerance flags, need the card all the same
    for flags in (["--resume", "--begin_epoch", "1"],
                  ["--auto-resume", "--save-every-n-steps", "2",
                   "--nan-policy", "skip"]):
        args = train_end2end.parse_args(["--synthetic", "--prefix",
                                         str(tmp_path / "e2e")] + flags)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_end2end.train_net(args)
    assert not list(tmp_path.iterdir())


def test_alternate_training_without_a_card_raises(monkeypatch, tmp_path):
    """``python -m mx_rcnn_tpu_torch.train_alternate`` and its three stage
    tools without ``--device`` need the card: they raise before writing
    anything."""
    from mx_rcnn_tpu_torch import train_alternate
    from mx_rcnn_tpu_torch.tools import test_rpn, train_rcnn, train_rpn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--synthetic", "--prefix", str(tmp_path / "alt"), "--root_path",
            str(tmp_path / "data")]
    for mod, run in ((train_alternate, train_alternate.alternate_train),
                     (train_rpn, train_rpn.train_rpn),
                     (train_rcnn, train_rcnn.train_rcnn),
                     (test_rpn, test_rpn.test_rpn)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(mod.parse_args(argv))
    assert not list(tmp_path.iterdir())


def test_test_driver_without_a_card_raises(monkeypatch, tmp_path):
    """``python -m mx_rcnn_tpu_torch.test`` without ``--device`` needs the
    card; the flags whose machinery is not ported raise by name."""
    from mx_rcnn_tpu_torch import test as test_driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = test_driver.parse_args(["--synthetic", "--prefix",
                                   str(tmp_path / "e2e")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_driver.test_rcnn(args)
    for flags, name in ((["--vis"], "--vis"),
                        (["--calibrate-shard", "4"], "--calibrate-shard"),
                        (["--devices", "2"], "--devices"),
                        (["--program-cache", "x"], "--program-cache"),
                        (["--obs-port", "9"], "--obs-port"),
                        (["--infer_dtype", "int8"], "int8")):
        with pytest.raises(NotImplementedError, match=name):
            test_driver.test_rcnn(test_driver.parse_args(
                ["--synthetic", "--device", "cpu"] + flags))
    assert not list(tmp_path.iterdir())


def test_serve_driver_without_a_card_raises(monkeypatch, tmp_path):
    """``python -m mx_rcnn_tpu_torch.serve`` without ``--device`` needs the
    card: it raises before building anything or binding its socket; the
    flags of the serving modes not ported are not accepted."""
    from mx_rcnn_tpu_torch.serve import driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock = tmp_path / "s.sock"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(driver.parse_args(["--synthetic", "--unix-socket",
                                       str(sock)]))
    assert not sock.exists()
    for flag in ("--replicas", "--fabric", "--join", "--models", "--cascade",
                 "--stream", "--watch-checkpoints", "--capture-dir",
                 "--trace", "--watch"):
        with pytest.raises(SystemExit):
            driver.parse_args(["--synthetic", flag, "1"])


def test_vgg_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    """``--network vgg16`` through every driver without ``--device``
    needs the card all the same: each raises before writing anything."""
    from mx_rcnn_tpu_torch import test as test_driver
    from mx_rcnn_tpu_torch import train_alternate, train_end2end
    from mx_rcnn_tpu_torch.serve import driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--network", "vgg16", "--synthetic", "--prefix",
            str(tmp_path / "vgg"), "--root_path", str(tmp_path / "data")]
    for mod, run in ((train_end2end, train_end2end.train_net),
                     (train_alternate, train_alternate.alternate_train),
                     (test_driver, test_driver.test_rcnn)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(mod.parse_args(argv))
    sock = tmp_path / "s.sock"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(driver.parse_args(["--network", "vgg16", "--synthetic",
                                       "--unix-socket", str(sock)]))
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_nms_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NMS kernels have no CPU mode")
    from mx_rcnn_tpu_torch.kernels import nms_cuda
    from mx_rcnn_tpu_torch.ops.nms import nms_padded

    rng = np.random.RandomState(0)
    b, n, max_out, thresh = 3, 4097, 300, 0.7
    ctr = rng.rand(b, n, 2) * 800
    wh = rng.rand(b, n, 2) * 150 + 10
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
                             .astype(np.float32)).cuda()
    valid = torch.from_numpy(rng.rand(b, n) > 0.02).cuda()
    ki, km = nms_cuda.nms_bitmask(boxes, valid, max_out, thresh)
    order = torch.arange(n, 0, -1, dtype=torch.float32, device="cuda")
    for i in range(b):
        ri, rm = nms_padded(boxes[i], order, max_out, thresh, valid=valid[i])
        assert torch.equal(ki[i][km[i]], ri[rm])
    # a chain (A kept, B removed, C kept) cut inside a 64-row block: kept
    # rows 0, 2, ..., 78, the 40th in block 1
    chain = torch.from_numpy(chip_smoke.chain_boxes(300, [(0, 300)])).cuda()
    ones = torch.ones(1, 300, dtype=torch.bool, device="cuda")
    ki, km = nms_cuda.nms_bitmask(chain[None], ones, 40, chip_smoke.CHAIN_THRESH)
    assert km.all()
    assert torch.equal(ki[0].long(), torch.arange(0, 80, 2, device="cuda"))
