"""The port's training CLIs against the JAX package's and against the
port's own step makers.

* ``run_epochs``: the four behaviours of ``tests/test_cli_loop.py``
  (periodic test evaluation, ``--test-max-iter``, test only on a val
  improvement, the weighted score), run by both packages' ``run_epochs``
  on the same fake steps and loaders: the same files written and the same
  batches evaluated.
* Argument defaults: both CLIs' ``get_args`` on an empty command line
  equal JAX's (the port adds ``--device`` alone).
* CLI mains on ``--device cpu`` with a reduced model (registered under a
  test name, or for DeNS given through ``--config-yml``): two training
  steps each of ``train_qm9`` on the QM9 fixture, ``train_md17`` on the
  MD17 fixture and ``train_md17 --use-dens``, whose ``final.npz`` equals in
  every bit the weights of the port's step makers driven by hand with the
  same generator (alpha dropout and the DeNS noise draw from it), and
  which JAX's ``load_params`` reads.
* The QM9 fixture's 11 molecules all fall into the train split: both
  packages' ``train_qm9`` raise ``KeyError`` at the first evaluation.
"""

import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from equiformer_tpu.cli import common as j_common  # noqa: E402
from equiformer_tpu.cli import train_md17 as j_train_md17  # noqa: E402
from equiformer_tpu.cli import train_qm9 as j_train_qm9  # noqa: E402
from equiformer_tpu.models import registry as j_registry  # noqa: E402
from equiformer_tpu.train import TrainState as JState  # noqa: E402
from equiformer_tpu.train.checkpoint import load_params as j_load_params  # noqa: E402
import equiformer_tpu_torch as pt  # noqa: E402
from equiformer_tpu_torch.cli import common, compute_stats as t_compute_stats  # noqa: E402
from equiformer_tpu_torch.cli import train_md17, train_qm9  # noqa: E402
from equiformer_tpu_torch.data import GraphLoader, load_md17, md17_like_dataset  # noqa: E402
from equiformer_tpu_torch.data.qm9 import load_qm9  # noqa: E402
from equiformer_tpu_torch.graph.batching import cli_capacities  # noqa: E402
from equiformer_tpu_torch.models import md17_models, registry  # noqa: E402
from equiformer_tpu_torch.models.equiformer import GraphAttentionTransformer as TModel  # noqa: E402
from equiformer_tpu_torch.utils import params_to_jax  # noqa: E402

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(irreps_node_embedding="8x0e+4x1e+2x2e", num_layers=1, irreps_sh="1x0e+1x1e+1x2e",
            fc_neurons=(8, 8), irreps_feature="16x0e", irreps_head="4x0e+2x1e+1x2e",
            num_heads=2, irreps_mlp_mid="12x0e+6x1e+3x2e")
DENS_YML = """model:
  irreps_node_embedding: 8x0e+4x1e+2x2e
  num_layers: 1
  irreps_sh: 1x0e+1x1e+1x2e
  irreps_equivariant_inputs: 1x0e+1x1e+1x2e
  number_of_basis: 8
  basis_type: exp
  fc_neurons: [8, 8]
  irreps_feature: 16x0e+4x1e+2x2e
  irreps_head: 4x0e+2x1e+1x2e
  num_heads: 2
  irreps_pre_attn: 8x0e+4x1e+2x2e
  irreps_mlp_mid: 12x0e+6x1e+3x2e
  nonlinear_message: true
  alpha_drop: 0.0
"""


def tiny_cli_qm9(radius=5.0, num_basis=128, device=None, task_mean=None, task_std=None, **kw):
    """A 1-block QM9 model taking the CLI's arguments."""
    return TModel(**TINY, max_radius=radius, number_of_basis=num_basis, alpha_drop=0.2,
                  higher_order_grads=False, task_mean=task_mean, task_std=task_std,
                  **kw).to(registry.resolve_device(device))


def tiny_cli_md17(radius=5.0, num_basis=128, device=None, **kw):
    """A 1-block MD17 force model with the attention head."""
    return TModel(**TINY, max_radius=radius, number_of_basis=num_basis, basis_type="exp",
                  alpha_drop=0.0, max_atom_type=64, use_attn_head=True,
                  avg_num_nodes=md17_models._AVG_NUM_NODES_MD17,
                  avg_degree=md17_models._AVG_DEGREE_MD17, **kw).to(registry.resolve_device(device))


for _fn in (tiny_cli_qm9, tiny_cli_md17):
    if _fn.__name__ not in registry._MODEL_REGISTRY:
        registry.register_model(_fn)


class _JaxStubModel:
    """Stands in for a JAX model where the CLI never applies it: ``init``
    gives a one-leaf tree at once (JAX's ``train_qm9`` inits outside jit)."""

    def init(self, rng, batch, deterministic=True):
        return {"params": {"w": jnp.zeros((1,))}}


if "stub_cli_qm9" not in j_registry._MODEL_REGISTRY:
    j_registry._MODEL_REGISTRY["stub_cli_qm9"] = lambda **kw: _JaxStubModel()


# ------------------------------------------------------------ run_epochs

class CountingLoader:
    """Identical fake batches, counting how many were consumed."""

    def __init__(self, n_batches, make):
        self.n_batches, self.make = n_batches, make
        self.iters = self.batches_consumed = 0

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        self.iters += 1
        for _ in range(self.n_batches):
            self.batches_consumed += 1
            yield self.make()


def _args(out, **kw):
    base = dict(output_dir=str(out), epochs=4, eval_interval=1, test_interval=2,
                test_max_iter=-1, print_freq=100, seed=0, batch_size=1, dp=1, evaluate=False)
    base.update(kw)
    return SimpleNamespace(**base)


def _jax_run(out, loaders, args_kw, **kw):
    state = JState.create({"w": jnp.zeros((1,))}, optax.sgd(0.0), use_ema=False)
    j_common.run_epochs(
        _args(out, **args_kw), state, lambda s, b, r: (s, {"loss": jnp.zeros(())}),
        lambda p, b: {"mae_sum": jnp.ones(()), "count": jnp.ones(())},
        *loaders, metric_keys=("loss",), **kw)


def _port_run(out, loaders, args_kw, **kw):
    model = torch.nn.Linear(1, 1)
    state = pt.TrainState.create(model, pt.create_optimizer(lambda s: 0.0), use_ema=False)
    common.run_epochs(
        _args(out, **args_kw), state, lambda s, b, g: (s, {"loss": torch.zeros(())}),
        lambda m, b: {"mae_sum": torch.ones(()), "count": torch.ones(()),
                      "pred": torch.zeros(3)},
        *loaders, metric_keys=("loss",), **kw)


RUN_CASES = {
    "periodic_test_eval": (dict(), (2, 1, 5), {}),
    "test_max_iter": (dict(test_max_iter=2), (2, 1, 5), {}),
    "test_only_on_val_improvement": (dict(test_interval=0), (2, 1, 3), {}),
    "weighted_score": (dict(epochs=2), (2, 1, None), {"score": True}),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_epochs_matches_jax(case, tmp_path):
    args_kw, sizes, opts = RUN_CASES[case]
    results = {}
    for name, run, make in (("jax", _jax_run, lambda: jnp.zeros((1,))),
                            ("port", _port_run, lambda: torch.zeros(1))):
        loaders = [None if n is None else CountingLoader(n, make) for n in sizes]
        calls = []
        kw = {}
        if opts.get("score"):
            kw["score_fn"] = lambda r: calls.append(r) or 0.2 * r["mae"] + 0.8 * r["mae"]
        out = tmp_path / name
        run(out, loaders, args_kw, **kw)
        results[name] = (sorted(f for f in os.listdir(out) if f.endswith(".npz")),
                         [(l.iters, l.batches_consumed) for l in loaders if l is not None],
                         calls)
    assert results["port"] == results["jax"]
    files, counts, calls = results["port"]
    assert "final.npz" in files and "best_val.npz" in files
    if case == "test_max_iter":
        assert counts[2][1] == 5 + 2 + 2
    if case == "weighted_score":
        assert len(calls) == 2 and "best_test.npz" not in files


def test_dp_above_one_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="M12"):
        _port_run(tmp_path, [CountingLoader(1, lambda: torch.zeros(1)), None], dict(dp=2))


# ------------------------------------------------------------ arguments

@pytest.mark.parametrize("cli", ["train_qm9", "train_md17"])
def test_cli_defaults_equal_jax(cli, monkeypatch):
    monkeypatch.setattr(sys, "argv", [cli])
    jargs = vars({"train_qm9": j_train_qm9, "train_md17": j_train_md17}[cli].get_args())
    targs = vars({"train_qm9": train_qm9, "train_md17": train_md17}[cli].get_args([]))
    assert targs.pop("device") is None
    assert targs == jargs


# ------------------------------------------------------------ CLI mains

def _copy(src, dst):
    shutil.copytree(os.path.join(FIX, src), dst)
    return str(dst)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _same_weights(path, model):
    got = _npz(path)
    want = {"/".join(("params",) + k): v for k, v in _flat(params_to_jax(model)).items()}
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # JAX's reader takes the file
    template = {"params": params_to_jax(model)}
    loaded = j_load_params(path, template)
    assert len(jax.tree_util.tree_leaves(loaded)) == len(got)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _by_hand(model, loader, opt_steps, step, extra=()):
    """Two steps of the port's step maker, as the CLI drives them."""
    next(iter(loader))
    state = pt.TrainState.create(model, opt_steps)
    gen = torch.Generator().manual_seed(0)
    n = 0
    for batch in loader:
        state, _ = step(state, batch, gen, *extra)
        n += 1
    assert n == 2
    return state


def test_train_qm9_main_equals_step_makers(tmp_path):
    root = _copy("qm9_raw", tmp_path / "qm9")
    out = tmp_path / "out"
    args = train_qm9.get_args(["--device", "cpu", "--data-path", root, "--batch-size", "4",
                               "--epochs", "1", "--eval-interval", "2", "--num-basis", "16",
                               "--no-amp", "--model-name", "tiny_cli_qm9",
                               "--output-dir", str(out)])
    train_qm9.main(args)
    assert sorted(f for f in os.listdir(out) if f.endswith(".npz")) == ["final.npz"]

    train, mean, std = load_qm9(root, "train", 1)
    nodes, edges = cli_capacities(4, 30, 17)
    model = tiny_cli_qm9(num_basis=16, max_edges=edges, task_mean=mean, task_std=std,
                         remat=True, drop_path_rate=0.0, compute_dtype=None, seed=0,
                         device="cpu")
    loader = GraphLoader(train, 4, nodes, seed=0)
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 10 * 2, 1 * 2, 1e-6), 5e-3)
    step, _ = pt.make_qm9_steps(model, opt, mean, std, "l1", ema_decay=0.999)
    _by_hand(model, loader, opt, step)
    _same_weights(str(out / "final.npz"), model)


@pytest.mark.parametrize("dens", [False, True], ids=["plain", "dens"])
def test_train_md17_main_equals_step_makers(dens, tmp_path):
    root = _copy("md17_raw", tmp_path / "md17")
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--data-path", root, "--train-size", "16", "--val-size", "8",
            "--epochs", "1", "--eval-interval", "2", "--output-dir", str(out)]
    if dens:
        yml = tmp_path / "dens.yml"
        yml.write_text(DENS_YML)
        argv += ["--use-dens", "--config-yml", str(yml), "--denoising-pos-weight", "2.5",
                 "--use-denoising-pos-weight-linear-decay"]
    else:
        argv += ["--model-name", "tiny_cli_md17", "--num-basis", "8"]
    args = train_md17.get_args(argv)
    train_md17.main(args)
    assert sorted(f for f in os.listdir(out) if f.endswith(".npz")) == ["final.npz"]

    train, mean, std = load_md17(root, "aspirin", "train", 16, 8)
    nodes, edges = cli_capacities(8, 21, 22)
    loader = GraphLoader(train, 8, nodes, seed=0, with_forces=True)
    opt = pt.create_optimizer(pt.cosine_warmup_schedule(5e-4, 10 * 2, 1 * 2, 1e-6), 5e-3)
    if dens:
        cfg = pt.utils.config.load_config(str(tmp_path / "dens.yml"))["model"]
        cfg["fc_neurons"] = tuple(cfg["fc_neurons"])
        model = pt.model_entrypoint("equiformer_md17_dens")(max_edges=edges, seed=0,
                                                            device="cpu", **cfg)
        step, _ = pt.make_dens_steps(model, opt, mean, std, energy_weight=0.2,
                                     force_weight=0.8, ema_decay=0.999)
        assert train_md17.dp_weight(args, 0) == 2.5
        _by_hand(model, loader, opt, step, extra=(2.5,))
    else:
        model = tiny_cli_md17(num_basis=8, max_edges=edges, remat=True, seed=0, device="cpu")
        step, _ = pt.make_md17_steps(model, opt, mean, std, 0.2, 0.8, ema_decay=0.999)
        _by_hand(model, loader, opt, step)
    _same_weights(str(out / "final.npz"), model)


def test_dp_weight_decays_linearly():
    args = train_md17.get_args(["--denoising-pos-weight", "3", "--epochs", "4",
                                "--use-denoising-pos-weight-linear-decay"])
    assert [train_md17.dp_weight(args, e) for e in range(4)] == [3.0, 2.25, 1.5, 0.75]


def test_empty_val_split_raises_in_both_packages(tmp_path, monkeypatch):
    """``--evaluate`` evaluates the (empty) val split at once; JAX's model
    is a stub, which its CLI inits and never applies on this path."""
    root = _copy("qm9_raw", tmp_path / "qm9")
    argv = ["--data-path", root, "--batch-size", "4", "--evaluate", "--num-basis", "8"]
    with pytest.raises(KeyError, match="mae_sum"):
        train_qm9.main(train_qm9.get_args(argv + [
            "--device", "cpu", "--model-name", "tiny_cli_qm9", "--output-dir",
            str(tmp_path / "t")]))
    monkeypatch.setattr(sys, "argv", ["train_qm9"] + argv + [
        "--model-name", "stub_cli_qm9", "--output-dir", str(tmp_path / "j")])
    with pytest.raises(KeyError, match="mae_sum"):
        j_train_qm9.main(j_train_qm9.get_args())


def test_cli_without_gpu_raises_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = train_qm9.get_args(["--synthetic", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_qm9.main(args)


def test_compute_stats_cli_native_and_numpy(tmp_path, capsys):
    root = _copy("md17_raw", tmp_path / "md17")
    base = ["--dataset", "md17", "--data-path", root, "--limit", "20"]
    nat = t_compute_stats.main(t_compute_stats.get_args(base))
    ref = t_compute_stats.main(t_compute_stats.get_args(base + ["--max-neighbors", "100"]))
    assert nat == ref and nat["avg_nodes"] == 21.0
    assert capsys.readouterr().out.count("avg_degree") == 2


def test_md17_eval_of_a_rematted_model_equals_the_plain_model():
    """The MD17 CLI evaluates its rematted model: an eval-mode force
    evaluation keeps its activations (remat is for training) and gives the
    un-rematted model's bits."""
    data = md17_like_dataset(2, num_atoms=9, seed=2)
    batch = next(iter(GraphLoader(data, 2, 32, shuffle=False, with_forces=True)))
    got = [pt.evaluate_md17(tiny_cli_md17(num_basis=8, max_edges=256, remat=r, seed=1,
                                          device="cpu"), batch)
           for r in (True, False)]
    for k in ("energy", "forces", "mae_e_sum", "mae_f_sum"):
        assert torch.equal(got[0][k], got[1][k]), k


def test_registry_names_the_loggers_and_their_output_matches_jax(tmp_path, capsys):
    from equiformer_tpu.utils import logger as j_logger
    from equiformer_tpu_torch.train import registry as t_registry
    from equiformer_tpu_torch.utils import logger as t_logger

    assert t_registry.get("logger", "file") is t_logger.FileLogger
    assert t_registry.get("logger", "jsonl") is t_logger.MetricsWriter
    assert t_registry.get("logger", "wandb") is t_logger.WandBLogger
    for kind, name in (("logger", "csv"), ("trainer", "file")):
        with pytest.raises(KeyError):
            t_registry.get(kind, name)
    assert t_registry.register("logger", "csv")(dict) is dict
    assert t_registry.get("logger", "csv") is dict
    del t_registry._REGISTRIES["logger"]["csv"]
    records = []
    for i, mod in enumerate((j_logger, t_logger)):
        out = tmp_path / str(i)
        w = mod.MetricsWriter(str(out))
        w.write(3, {"loss": np.float32(0.25), "mae": 1.5}, prefix="train")
        w.write(4, {"loss": 2})
        w.close()
        lines = (out / "metrics.jsonl").read_text().splitlines()
        records.append([{k: v for k, v in json.loads(ln).items() if k != "time"}
                        for ln in lines])
    assert records[0] == records[1] == [{"step": 3, "train/loss": 0.25, "train/mae": 1.5},
                                        {"step": 4, "loss": 2.0}]
    log = t_registry.get("logger", "file")(output_dir=str(tmp_path / "log"))
    log.info("epoch %d", 7)
    assert (tmp_path / "log" / "debug.log").read_text().rstrip().endswith(" - epoch 7")
    assert "epoch 7" in capsys.readouterr().out
    for h in list(log._logger.handlers):
        log._logger.removeHandler(h)
        h.close()
    wb = t_registry.get("logger", "wandb")(str(tmp_path), enabled=False)
    wb.add_scalars(1, {"loss": 1.0})
    wb.close()
