"""The training and analysis CLIs under a two-rank torchrun environment.

One spawn of 2 rank processes (``tests/torch_dist_workers.py``, gloo on the
CPU, one thread each), each with torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``, a port
bound to 0 for each launch), runs ``train.experiment.main`` on a tiny wav
corpus with ``--ddp``, then with ``--fsdp`` (narrow DCNN, packets, 2 epochs
with validation, test, snapshot and true-index dump), then ``analysis.cli
fingerprints --sp``, then ``--pp-stages 2`` (a ``test64`` AST, embed 64,
depth 4, its encoder pipelined over the two ranks, kernel 4's plain
version in its blocks).  Held here:

* rank 0 alone writes the snapshots, the ``.state.pt`` files, the results
  and the true-index dumps; each launch leaves no process group behind;
* each ``.pt`` loads into a single-process model behind the scorer and
  scores as the resumed ``.state.pt`` does, and its test metrics and
  true-index dump equal one process's evaluation of it;
* ``fingerprints --sp`` writes the JAX CLI's files and arrays;
* ``--pp-stages 2`` trains, rank 0 alone writes, and its snapshot
  evaluates in one process as the two ranks evaluated it.
"""

import json
import socket
import wave

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from audiodeepfake_detection_tpu.analysis import cli as jax_cli
from audiodeepfake_detection_tpu.analysis import fingerprints as jax_fingerprints
from audiodeepfake_detection_tpu.parallel.mesh import get_mesh
from audiodeepfake_detection_tpu_torch.models.factory import get_model
from audiodeepfake_detection_tpu_torch.train.experiment import create_data_loaders, get_input_dims
from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn
from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
from audiodeepfake_detection_tpu_torch.train.transforms import get_transforms, normalized_transform
from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

SR = 22050
WIDTHS = dict(ochannels1=8, ochannels2=8, ochannels3=12, ochannels4=16, ochannels5=4)
MODES = ["ddp", "fsdp"]


def _write_wav(path, samples, sr=SR):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes())


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


GRID = {"module": ["DCNN"], "time_dim_add": [1], "flattend_size": [320],
        "only_use": [["real", "fbmelgan"]], "limit_train": [(100, 100, 100)],
        "learning_rate": [4e-4], "weight_decay": [1e-3], "get_details": [True],
        **{k: [v] for k, v in WIDTHS.items()}}
#: the pipelined AST's grid point (the test64 size is patched in by the ranks)
GRID_PP = {"module": ["AST"], "ast_model_size": ["test64"], "ast_fused_attention": [True],
           "flattend_size": [None],  # the AST's time patches from the probed image
           **{k: GRID[k] for k in ("only_use", "limit_train", "learning_rate", "weight_decay",
                                   "get_details")}}
FLAGS = ["--device", "cpu", "--epochs", "2", "--batch-size", "4", "--model", "modules",
         "--transform", "packets", "--wavelet", "haar", "--log-scale",
         "--calc-normalization", "--init-seeds", "0"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    corpus = root / "corpus"
    rng = np.random.RandomState(0)
    for dirname, kind in (("A_real", "tone"), ("B_fbmelgan", "noise")):
        (corpus / dirname).mkdir(parents=True)
        for i in range(4):
            t = np.arange(4 * SR) / SR
            x = (0.5 * np.sin(2 * np.pi * (300 + 50 * i) * t) if kind == "tone"
                 else 0.3 * rng.randn(4 * SR))
            _write_wav(corpus / dirname / f"clip{i}.wav", x.astype(np.float32))
    (root / "meta").mkdir()
    paths = dict(data_path=[str(corpus)], save_path=[str(root / "meta")])
    for name, grid in (("grid", GRID), ("grid_pp", GRID_PP)):
        (root / f"{name}.py").write_text(
            f"def get_config():\n    return {dict(grid, **paths)!r}\n")
    prefix = ["--data-prefix", str(corpus) + "/fake_22050_22050_0.7_fbmelgan"]
    spec = {mode: ["--enable-gs", "--config", str(root / "grid.py"), *FLAGS, *prefix,
                   "--log-dir", str(root / mode), f"--{mode}"] for mode in MODES}
    spec["pp"] = ["--enable-gs", "--config", str(root / "grid_pp.py"), *FLAGS, *prefix,
                  "--log-dir", str(root / "pp"), "--pp-stages", "2"]
    spec["sp"] = ["fingerprints", "--data-path", str(corpus), "--generators", "fbmelgan",
                  "--max-files", "2", "--sp", "--device", "cpu", "--out-dir", str(root / "sp")]
    (root / "argv.json").write_text(json.dumps(spec))
    ports = [_free_port() for _ in range(4)]
    workers.spawn("cli", str(root), 2, extra=ports, env=lambda rank: {
        "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
        "MASTER_ADDR": "127.0.0.1"})
    ranks = [torch.load(root / f"cli_rank{r}.pt", weights_only=False) for r in range(2)]
    return root, corpus, ranks


def _args(root, corpus, mode, grid=GRID):
    """The configuration of a launch's grid point, as ``main`` builds it."""
    a = default_config()
    a.update({k: v[0] for k, v in grid.items()})
    a.update(data_path=str(corpus), save_path=str(root / "meta"),
             data_prefix=str(corpus) + "/fake_22050_22050_0.7_fbmelgan",
             log_dir=str(root / mode), transform="packets", wavelet="haar", log_scale=True,
             batch_size=4, epochs=2, model="modules", calc_normalization=True, seed=0,
             device="cpu", enable_gs=True, init_seeds=[0])
    return DotDict(a)


def test_rank_zero_alone_writes(run):
    _, _, ranks = run
    assert ranks[1]["writes"] == []
    writes = ranks[0]["writes"]
    for mode in MODES:
        paths = [w for w in writes if isinstance(w, str) and f"/{mode}/" in w]
        # two epochs: each writes the .pt and the .state.pt
        assert len([p for p in paths if p.endswith(".state.pt")]) == 2, mode
        assert len([p for p in paths if p.endswith(".pt") and not p.endswith(".state.pt")]) == 2
    assert [w[0] for w in writes if isinstance(w, tuple)] == [
        "true_ind", "results", "true_ind", "results"]
    assert not ranks[0]["group_left"] and not ranks[1]["group_left"]


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_scores_and_evaluates_as_one_process(run, mode):
    root, corpus, ranks = run
    snapshot = next(w for w in ranks[0]["writes"] if isinstance(w, str)
                    and f"/{mode}/" in w and w.endswith(".pt") and ".state" not in w)
    # one process: the same loaders, stats, model and snapshot, then testing()
    args = _args(root, corpus, mode)
    loaders = create_data_loaders(args)
    base, mean, std = get_transforms(args, device="cpu")  # the norm cache rank 0 wrote
    args.input_dim = get_input_dims(args, base, "cpu")
    transform = normalized_transform(base, mean, std)
    trainer = Trainer(get_model(args, "modules"), transform, args, snapshot[:-len(".pt")],
                      *loaders, device="cpu")
    trainer.load_snapshot()

    # the reference .pt alone, into a fresh model behind the scorer
    scorer_model = get_model(args, "modules")
    scorer_model.load_state_dict(torch.load(snapshot, weights_only=True)["MODEL_STATE"])
    score = make_score_fn(scorer_model, transform, "cpu")
    audio = torch.from_numpy(np.random.RandomState(1).randn(3, 1, SR).astype(np.float32))
    assert torch.equal(score(audio), make_score_fn(trainer.model, transform, "cpu")(audio))
    results = [float(r) for r in trainer.testing()]
    distributed = [w[1] for w in ranks[0]["writes"] if isinstance(w, tuple)
                   and w[0] == "results"][MODES.index(mode)]
    # the same frames through the same weights: the rows gathered from the
    # ranks and put in dataset order give the same accuracy and EER
    assert distributed == {0: [results]} or distributed == {"0": [results]}
    dump = next(w[1] for w in ranks[0]["writes"] if isinstance(w, tuple)
                and w[0] == "true_ind" and f"/{mode}/" in w[1])
    got = np.load(dump, allow_pickle=True).item()
    np.testing.assert_array_equal(got["known"], trainer.current_true_indices["test known"])


def test_pp_stages_trains_through_main(run, monkeypatch):
    """``main --pp-stages 2``: rank 0 alone writes the two epochs' ``.pt``
    and ``.state.pt``, the results and the true-index dump; the snapshot,
    loaded into one process's AST, evaluates as the two ranks did."""
    from audiodeepfake_detection_tpu_torch.models import ast

    root, corpus, ranks = run
    monkeypatch.setitem(ast._SIZES, "test64", workers.AST_SIZE["test64"])
    assert ranks[1]["pp_writes"] == []
    writes = ranks[0]["pp_writes"]
    paths = [w for w in writes if isinstance(w, str)]
    assert len([p for p in paths if p.endswith(".state.pt")]) == 2 and len(paths) == 4
    assert [w[0] for w in writes if isinstance(w, tuple)] == ["true_ind", "results"]
    snapshot = next(p for p in paths if ".state" not in p)
    args = _args(root, corpus, "pp", GRID_PP)
    loaders = create_data_loaders(args)
    base, mean, std = get_transforms(args, device="cpu")
    args.input_dim = get_input_dims(args, base, "cpu")
    trainer = Trainer(get_model(args, "modules"), normalized_transform(base, mean, std), args,
                      snapshot[:-len(".pt")], *loaders, device="cpu")
    trainer.load_snapshot()
    assert trainer.model.get_name() == "AST" and trainer.epochs_run == 2
    results = [float(r) for r in trainer.testing()]
    distributed = next(w[1] for w in writes if isinstance(w, tuple) and w[0] == "results")
    assert distributed == {0: [results]} or distributed == {"0": [results]}


def test_fingerprints_sp_writes_the_jax_files(run, tmp_path, eight_devices):
    """The JAX CLI's file names; its arrays from JAX's function over a mesh
    of as many devices as the launch had ranks (the crop to a multiple of
    ``shards * 2**level`` follows the shard count: 65,536 of a clip's
    88,200 samples over 2)."""
    root, corpus, _ = run
    jax_cli.main(["fingerprints", "--data-path", str(corpus), "--generators", "fbmelgan",
                  "--max-files", "2", "--sp", "--out-dir", str(tmp_path)])
    ours = root / "sp"
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(p.name for p in ours.iterdir()) and len(names) == 8
    want = jax_fingerprints.generator_fingerprints(
        str(corpus), ["fbmelgan"], max_files=2, mesh=get_mesh(eight_devices[:2]))
    for name in names:
        if name.endswith(".npy"):
            gen, key = name[:-4].split("_", 1)
            got = np.load(ours / name)
            if "wpt" in key:
                # level-14 haar over 2 ranks against JAX's over 2 devices;
                # the one-device CLI test's bound (measured 0.0)
                np.testing.assert_allclose(got, want[gen][key], rtol=1e-6,
                                           atol=1e-6 * np.abs(want[gen][key]).max())
            else:  # numpy's rFFT, whatever the mesh
                np.testing.assert_array_equal(got, np.load(tmp_path / name))
        else:
            assert (ours / name).read_bytes() == (tmp_path / name).read_bytes()
