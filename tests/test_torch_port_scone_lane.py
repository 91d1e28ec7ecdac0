"""The SCONE pretraining lane end to end on the CPU, at full widths and
tiny batches: the coverage-gain pretrainer for 2 epochs on the port's own
SconeOcc checkpoint, resumed for a third; the ShapeNet tester over the
test split; the MACARONS checkpoint assembled from both, which the online
trainer's set-up loads weight for weight with ``pretrained: true``; the
initialize_cov, test_shapenet and generate_macarons_model CLIs with
``--device cpu``, and their default device raising without a card. The
parity of each step with the JAX package is held in
test_torch_port_pretrain_{occ,vis}.py."""

import json
import os

import numpy as np
import pytest
import torch

from macarons_tpu_torch import initialize_cov, test_shapenet
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.models.attention import init_weights
from macarons_tpu_torch.models.macarons import create_macarons_model, \
    load_macarons
from macarons_tpu_torch.testers import shapenet as ts
from macarons_tpu_torch.trainers import pretrain_occ as po
from macarons_tpu_torch.trainers import pretrain_vis as pv
from macarons_tpu_torch.trainers.train_macarons import run_training
from macarons_tpu_torch.utils import generate_macarons_model as gmm
from macarons_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_pretrain_vis import VIS_SMALL
from torch_port_helpers import make_scene_root, make_shapenet_root, \
    torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return make_shapenet_root(tmp_path_factory)


def test_run_training_test_and_assembly(shapenet_root, tmp_path,
                                        tmp_path_factory, monkeypatch):
    """Full-width networks at tiny batches on the CPU: the vis pretrainer
    for 2 epochs on an occ checkpoint of the port, resumed for a third;
    the tester over the test split (coverage never decreases); the
    MACARONS checkpoint assembled from both, which the online trainer's
    set-up loads weight for weight with ``pretrained: true``; the CLIs."""
    w = str(tmp_path / "w")
    params = Params(dict(VIS_SMALL, data_path=shapenet_root, batch_size=4))
    occ = init_weights(po.build_model(params),
                       torch.Generator().manual_seed(0))
    save_checkpoint(os.path.join(w, "occ"), occ, {"epoch": 0})
    _, tl, vl, nbv = pv.run_training(
        params, weights_dir=w, occ_weights_path=os.path.join(w, "occ"),
        max_batches_per_epoch=1, device="cpu", verbose=False)
    assert len(tl) == len(vl) == len(nbv) == 2 and np.isfinite(tl).all()
    params3 = Params(dict(params.to_dict(), epochs=3,
                          start_from_scratch=False))
    model, tl3, _, nbv3 = pv.run_training(
        params3, weights_dir=w, occ_weights_path=os.path.join(w, "occ"),
        max_batches_per_epoch=1, device="cpu", verbose=False)
    assert tl3[:2] == tl and nbv3[:2] == nbv and len(tl3) == 3
    res = ts.run_test(params, occ_weights_path=os.path.join(w, "occ"),
                      vis_weights_path=os.path.join(w, "unvalidated_test_vis"),
                      results_dir=str(tmp_path / "res"), max_meshes=2,
                      device="cpu", verbose=False)
    assert len(res["coverages"]) == 2
    for cov in res["coverages"].values():
        assert np.all(np.diff(cov) >= 0)
    assert os.path.exists(tmp_path / "res" / "results_seen.json")

    scenes = make_scene_root(tmp_path_factory)
    tparams = Params(dict(json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(__file__)),
        "configs/macarons/macarons_default_training_config.json"))),
        data_path=scenes, epochs=0, use_perfect_depth=True))
    out = os.path.join(w, "assembled")
    gmm.main(["-o", os.path.join(w, "occ"), "-c",
              os.path.join(w, "unvalidated_test_vis"), "--out", out,
              "--config", str(_write(tmp_path / "t.json", tparams)),
              "--device", "cpu"])
    trained, _ = run_training(Params(dict(
        tparams.to_dict(), pretrained=True, pretrained_model_path=out)),
        weights_dir=str(tmp_path / "mw"), device="cpu", verbose=False)
    for net, ref in ((trained.occ, occ), (trained.vis, model)):
        sd = net.state_dict()
        for k, v in ref.state_dict().items():
            assert torch.equal(sd[k], v), k
    check = create_macarons_model(tparams)
    load_macarons(out, check)
    assert torch.equal(check.vis.fc3.weight, model.fc3.weight)

    conf = _write(tmp_path / "vis.json", Params(dict(VIS_SMALL, epochs=1,
                                                     batch_size=4)))
    initialize_cov.main(["-c", str(conf), "--data-path", shapenet_root,
                         "--weights-dir", str(tmp_path / "cli"),
                         "--device", "cpu"])
    assert os.path.exists(tmp_path / "cli" / "best_unval_test_vis.pt")
    test_conf = _write(tmp_path / "test.json", Params(dict(
        training_config=str(conf), max_meshes=1, n_view_max=3,
        occ_weights_path="w/occ",
        vis_weights_path="cli/unvalidated_test_vis")))
    test_shapenet.main(["-c", str(test_conf), "--data-path", shapenet_root,
                        "--weights-dir", str(tmp_path), "--results-dir",
                        str(tmp_path / "cli_res"), "--device", "cpu"])
    out = json.load(open(tmp_path / "cli_res" / "results_seen.json"))
    assert len(out["mean_coverages"]) == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli, argv in ((initialize_cov, ["-c", str(conf)]),
                      (test_shapenet, ["-c", str(test_conf)]),
                      (gmm, ["--config", str(tmp_path / "t.json")])):
        with pytest.raises(RuntimeError):
            cli.main(argv)


def _write(path, params):
    path.write_text(json.dumps(params.to_dict()))
    return path
