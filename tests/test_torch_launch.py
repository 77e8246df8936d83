"""The port's launch layer against the reference: the configs (every field
of every registered arch, full and reduced; INPUT_SHAPES; the paper's
Section 5 constants), the specs (meta-device stand-ins), the step builders
on the reduced configs, the optimizers and schedules, token_batch, and the
training driver `launch.train.main` end to end on the CPU.

Tolerances: the train step's theta_L and bank within rtol 1e-4, atol 1e-6
(tests/test_torch_federation.py's: two autodiff systems sum in other
orders, and the Laplace transform's log1p may differ by an ulp); prefill
and decode logits within 1e-5 (dense f32 paths), within one bf16 step of
the largest logit on the MoE's onehot dispatch (tests/test_torch_moe.py);
the optimizers within 1e-6 relative; owner sequences, ledgers, token
batches and specs exactly.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import linreg_paper as jpaper
from repro.launch import specs as jspecs
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import build_step as jax_build_step
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.configs import linreg_paper as tpaper
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.launch import specs as tspecs
from repro_torch.launch.steps import StepBundle, build_step, default_async_cfg
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
SHAPES = [tconfigs.ShapeConfig("t", 32, 4, "train"),
          tconfigs.ShapeConfig("p", 48, 2, "prefill"),
          tconfigs.ShapeConfig("d", 16, 2, "decode")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in tree_flatten(tree)[0]]


def _jshapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------- configs
def test_registry_and_every_config_field_equal_the_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(tconfigs.list_archs()) == 10
    assert sorted(tconfigs.all_configs()) == tconfigs.list_archs()
    for arch in tconfigs.list_archs():
        for mine, ref in ((tconfigs.get_config(arch), jconfigs.get_config(arch)),
                          (tconfigs.get_config(arch).reduced(),
                           jconfigs.get_config(arch).reduced())):
            assert [f.name for f in dataclasses.fields(mine)] == [
                f.name for f in dataclasses.fields(ref)]
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    for name, shape in jconfigs.INPUT_SHAPES.items():
        assert dataclasses.asdict(tconfigs.get_shape(name)) == dataclasses.asdict(shape)
    assert sorted(tconfigs.INPUT_SHAPES) == sorted(jconfigs.INPUT_SHAPES)
    for mine, ref in ((tpaper.LENDING, jpaper.LENDING), (tpaper.HEALTH, jpaper.HEALTH),
                      (tpaper.CONFIG, jpaper.CONFIG)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref) and mine.sigma == ref.sigma


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-30b-a3b", "xlstm-125m", "yi-6b",
                                  "zamba2-2.7b", "internvl2-2b", "whisper-medium",
                                  "granite-20b", "command-r-35b", "qwen1.5-110b"])
def test_param_count_is_the_leaves_of_init_at_full_width(arch):
    """`param_count` (the port's rule: every leaf its init makes) against
    the reference's init traced abstractly at full width, and the port's
    own meta init: nothing is drawn or allocated, even at 140 B leaves."""
    cfg = tconfigs.get_config(arch)
    jlm = jax_build_model(jconfigs.get_config(arch), remat=False)
    want = jax.eval_shape(lambda k: jlm.init(k, jnp.float32),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert cfg.param_count() == sum(int(np.prod(x.shape))
                                    for x in jax.tree_util.tree_leaves(want))
    meta = tspecs.params_specs(LM(cfg), torch.float32)
    leaves = tree_flatten(meta)[0]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()
    assert _shapes(meta) == _jshapes(want)


# ---------------------------------------------------------------- specs
@pytest.mark.parametrize("arch", ["xlstm-125m", "qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_specs_match_the_reference(arch):
    cfg, jcfg = tconfigs.get_config(arch).reduced(), jconfigs.get_config(arch).reduced()
    jlm = jax_build_model(jcfg, remat=False)
    lm = LM(cfg)
    long = tconfigs.get_shape("long_500k")
    for shape in SHAPES + [long, tconfigs.get_shape("train_4k")]:
        jshape = jconfigs.ShapeConfig(**dataclasses.asdict(shape))
        assert tspecs.effective_window(cfg, shape) == jspecs.effective_window(jcfg, jshape)
        for mb in (0, 2):
            got = tspecs.train_batch_specs(cfg, shape, microbatches=mb)
            want = jspecs.train_batch_specs(jcfg, jshape, microbatches=mb)
            assert sorted(got) == sorted(want)
            assert _shapes(got) == _jshapes(want)
            assert all(t.device.type == "meta" for t in got.values())
        assert _shapes(tspecs.decode_input_specs(cfg, shape)) == _jshapes(
            jspecs.decode_input_specs(jcfg, jshape))
    for shape in SHAPES:
        jshape = jconfigs.ShapeConfig(**dataclasses.asdict(shape))
        assert _shapes(tspecs.cache_specs_struct(lm, shape)) == _jshapes(
            jspecs.cache_specs_struct(jlm, jshape))
        got = tspecs.input_specs(cfg, shape, lm)
        want = jspecs.input_specs(jcfg, jshape, jlm)
        assert sorted(got) == sorted(want) and _shapes(got) == _jshapes(want)
    assert _shapes(tspecs.params_specs(lm)) == _jshapes(jspecs.params_specs(jlm))


# ---------------------------------------------------------------- steps
@pytest.mark.parametrize("arch", ["xlstm-125m", "qwen3-moe-30b-a3b", "mixtral-8x22b"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.kind)
def test_build_step_runs_and_matches_the_reference_step(arch, shape):
    """Each kind on the reduced config, f32, against the reference's bundle
    on a 1 x 1 debug mesh: the same weights (converted), batch, owner and
    key."""
    cfg, jcfg = tconfigs.get_config(arch).reduced(), jconfigs.get_config(arch).reduced()
    jb = jax_build_step(jcfg, shape, make_debug_mesh(1, 1), n_microbatches=2, dtype=jnp.float32)
    tb = build_step(cfg, shape, None, n_microbatches=2, dtype=torch.float32, device=CPU)
    assert isinstance(tb, StepBundle) and tb.kind == jb.kind and tb.in_shardings is None
    assert tb.donate_argnums == jb.donate_argnums
    from repro_torch.checkpoint import flatten_with_paths
    assert all(t.device.type == "meta" for t in flatten_with_paths(tb.args[:2]).values())
    jparams = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(4), jnp.float32)
    params = params_from_numpy(_np(jparams), device=CPU)
    rng = np.random.default_rng(5)
    B, S = shape.global_batch, shape.seq_len
    onehot = cfg.family == "moe"
    if shape.kind == "train":
        from repro.federation.deep import init_state as jinit
        from repro.launch.steps import default_async_cfg as jdefault
        from repro_torch.federation.deep import init_state as tinit
        from repro_torch import random as trandom
        toks = rng.integers(0, cfg.vocab, size=(2, B // 2, S), dtype=np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
        assert _shapes(tb.args[1]) == [((2, B // 2, S), "int32")] * 2
        acfg = default_async_cfg(n_microbatches=2)
        js, jm = jax.jit(jb.step)(jinit(jparams, jdefault(n_microbatches=2)),
                                  {k: jnp.asarray(v) for k, v in
                                                          batch.items()},
                                  jnp.int32(2), jax.random.PRNGKey(7))
        ts, tm = tb.step(tinit(params, acfg, device=CPU),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.tensor([2], dtype=torch.int32), trandom.PRNGKey(7, device=CPU))
        assert int(ts.step) == int(js.step) == 1
        assert float(tm["clip_frac"]) == float(jm["clip_frac"])
        for a, b in zip(tree_flatten(ts.theta_L)[0] + tree_flatten(ts.bank)[0],
                        jax.tree_util.tree_leaves(js.theta_L) + jax.tree_util.tree_leaves(js.bank)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
        return
    toks = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    if shape.kind == "prefill":
        want = np.asarray(jax.jit(jb.step)(jparams, {"tokens": jnp.asarray(toks)}))
        got = tb.step(params, {"tokens": torch.from_numpy(toks)}).numpy()
    else:
        jmodel = jax_build_model(jcfg)
        jcache = jmodel.init_cache(B, S, dtype=jnp.float32)
        cache = cache_from_numpy(_np(jcache), device=CPU)
        jstep = jax.jit(jb.step)
        for t in range(4):
            jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            tl, cache = tb.step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        want, got = np.asarray(jl), tl.numpy()
    tol = 2.0 ** -8 * float(np.abs(want).max()) if onehot else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------- optim, data
def test_optimizers_and_schedules_match_the_reference():
    import repro.optim as jopt
    import repro_torch.optim as topt
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                    params) for _ in range(3)]
    to_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)  # noqa: E731
    for jmake, tmake in ((lambda m: m.sgd(m.constant(0.1)), None),
                         (lambda m: m.sgd(m.linear_warmup(0.2, 2), momentum=0.9), None),
                         (lambda m: m.adamw(m.cosine_decay(0.05, 10, warmup=2, floor=0.01),
                                            weight_decay=0.01), None),
                         (lambda m: m.inertia_sgd(4, 100, 1.0, 1e-2, 0.5), None)):
        jinit, jupd = jmake(jopt)
        tinit, tupd = jmake(topt)
        jp, tp = params, to_t(params)
        js, ts = jinit(jp), tinit(tp)
        for g in grads:
            ju, js = jupd(g, js, jp)
            tu, ts = tupd(to_t(g), ts, tp)
            jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for a, b in zip(tree_flatten(tp)[0], jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        assert int(ts.count) == int(js.count) == 3
    for s in (0, 1, 3, 7, 12):
        for jf, tf in ((jopt.constant(0.3), topt.constant(0.3)),
                       (jopt.linear_warmup(0.3, 4), topt.linear_warmup(0.3, 4)),
                       (jopt.cosine_decay(0.3, 10, warmup=3, floor=0.02),
                        topt.cosine_decay(0.3, 10, warmup=3, floor=0.02))):
            assert float(tf(torch.tensor(s, dtype=torch.int32))) == pytest.approx(
                float(jf(jnp.int32(s))), rel=1e-6)


def test_token_batch_bit_for_bit():
    from repro.data.synthetic import token_batch as jtb
    from repro_torch.data import token_batch
    for seed in (0, 7, np.random.default_rng(3)):
        want = jtb(seed if not isinstance(seed, np.random.Generator) else np.random.default_rng(3),
                   3, 17, 512)
        got = token_batch(seed, 3, 17, 512)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------- the launcher
def _run_log(out):
    """(owners of the printed steps, the ledger line) of a driver's stdout."""
    owners = [int(m) for m in re.findall(r"owner=(\d+)", out)]
    ledger = [ln for ln in out.splitlines() if ln.startswith("privacy ledger:")]
    return owners, ledger


def _twin(capsys, tmp_path, arch, extra):
    """The reference's driver and the port's on the same argv, the port
    given the reference's initial weights (its init from --seed's split)."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main as tmain
    argv = ["--arch", arch, "--steps", "3", "--batch", "4", "--seq", "32", "--records", "64",
            *extra]
    js = jmain(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    jout = capsys.readouterr().out
    jcfg = jconfigs.get_config(arch).reduced()
    jlm = jax_build_model(jcfg, remat=False, moe_mode="ragged")
    init_key = jax.random.split(jax.random.PRNGKey(0))[1]
    params = params_from_numpy(_np(jlm.init(init_key, jnp.float32)), device=CPU)
    ts = tmain(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")], params=params)
    tout = capsys.readouterr().out
    assert _run_log(tout) == _run_log(jout)
    assert len(_run_log(tout)[0]) == 3 and _run_log(tout)[1]
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(tree_flatten(ts.theta_L)[0], jax.tree_util.tree_leaves(js.theta_L)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    return js, ts


def test_train_main_on_the_reduced_xlstm_matches_the_reference(capsys, tmp_path):
    """The twin of tests/test_system.py::test_train_driver_end_to_end: per-
    example granularity (vmap of grad through the xLSTM), the owner
    sequence and the ledger exact, theta_L within tolerance, and the port's
    checkpoint loads into the reference's state with repro.checkpoint."""
    from repro.checkpoint import load_checkpoint
    from repro_torch.checkpoint import flatten_with_paths
    js, ts = _twin(capsys, tmp_path, "xlstm-125m", [])
    path = tmp_path / "port" / "step_00000003" / "arrays.npz"
    assert path.exists()
    loaded = load_checkpoint(str(tmp_path / "port"), 3, js)
    mine = flatten_with_paths(ts)
    assert "theta_L/blocks/0/mlstm/w_q" in mine and "bank/blocks/1/slstm/r" in mine
    got, _ = jax.tree_util.tree_flatten_with_path(loaded)
    assert len(got) == len(mine)
    for (jpath, leaf), (key, t) in zip(got, mine.items()):
        assert "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                        for p in jpath) == key
        np.testing.assert_array_equal(np.asarray(leaf), t.numpy())


def test_train_main_moe_at_microbatch_granularity(capsys, tmp_path):
    """The reduced qwen3-moe under the launcher's ragged dispatch: per-example
    granularity raises (vmap, as the reference's ragged_dot); microbatch
    granularity trains as the reference's does."""
    from repro_torch.launch.train import main as tmain
    with pytest.raises(NotImplementedError, match="vmap"):
        tmain(["--arch", "qwen3-moe-30b-a3b", "--steps", "1", "--batch", "4", "--seq", "16",
               "--records", "32", "--device", "cpu"])
    capsys.readouterr()
    _twin(capsys, tmp_path, "qwen3-moe-30b-a3b", ["--granularity", "microbatch"])
