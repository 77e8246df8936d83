"""The port's example twins (examples/*_torch.py) on the CPU, held against
the reference's examples.

  * async_dp_llm_torch.py: `main` at --tiny through the fused run_rounds
    dispatches and the per-round step loop (with --fused, the flat engine),
    printing what examples/async_dp_llm.py prints;
  * collaboration_forecast_torch.py: `measure(N, eps, runs=2)` against the
    reference example's `measure` on the same lending shards and key: psi
    within rtol 1e-5 and atol 1e-5, the convex engine's parity tolerance
    (tests/test_torch_convex.py: two f32 matrix-vector products a step in
    another order over T = 1000 steps); then `main`, its printed lines;
  * serve_hybrid_torch.py: on the reference example's weights (zamba2-2.7b
    reduced, drawn from its key and carried across by repro_torch.convert)
    the prompt and the first 8 greedy tokens equal those the reference
    example prints, token for token.
"""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    # one torch thread per test process: the suite runs in several workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sample(out):
    """The token ids of the `sample:` line an example printed."""
    line = out[out.index("sample:"):].split("...")[0]
    return [int(t) for t in re.findall(r"\d+", line)]


@pytest.mark.parametrize("argv", [
    ["--tiny", "--steps", "4", "--rounds-per-dispatch", "2"],
    ["--tiny", "--steps", "2", "--rounds-per-dispatch", "1", "--fused"],
], ids=["run_rounds", "step-fused"])
def test_async_dp_llm_twin_runs_on_cpu(argv, capsys):
    losses = _example("async_dp_llm_torch").main(argv + ["--device", CPU])
    out = capsys.readouterr().out
    assert out.startswith("model: dense-124m-smoke (")
    assert "privacy ledger:" in out and out.count("  owner ") == 4
    assert all(np.isfinite(losses))
    if "1" not in argv:
        assert len(losses) == 2 and "(2 rounds/dispatch, 2 granted)" in out


@pytest.mark.parametrize("n,eps", [(5, 2.0), (3, 10.0)])
def test_forecast_measure_matches_reference_example(n, eps):
    ours = _example("collaboration_forecast_torch").measure(n, eps, runs=2, device=CPU)[2]
    ref = _example("collaboration_forecast").measure(n, eps, runs=2)[2]
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_forecast_twin_main_runs_on_cpu(capsys):
    pilot, (c1, c2), psi_iso = _example("collaboration_forecast_torch").main(CPU)
    out = capsys.readouterr().out
    assert sorted(pilot) == [2.0, 5.0, 10.0] and np.isfinite([c1, c2, psi_iso]).all()
    for line in ("fitted constants:", "isolated owner-0 model: psi =",
                 "forecast (eq. 11): min owners for collaboration to win", "eps=  0.5: N >="):
        assert line in out


def test_serve_twin_tokens_match_reference_example(capsys):
    from repro.configs import get_config
    from repro.models import build_model
    from repro_torch.convert import params_from_numpy
    jcfg = get_config("zamba2-2.7b").reduced()
    k_init, _ = jax.random.split(jax.random.PRNGKey(0))
    jparams = build_model(jcfg, remat=False).init(k_init, jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    seqs = _example("serve_hybrid_torch").main(CPU, params=params, gen=8)
    ours = capsys.readouterr().out
    _example("serve_hybrid").main()
    ref = _sample(capsys.readouterr().out)
    assert seqs.shape == (4, 16)
    assert seqs[0].tolist() == ref[:16]          # 8 prompt tokens, 8 greedy tokens
    assert "zamba2 hybrid decode: 4 seqs x 16 tokens" in ours
    assert _sample(ours) == seqs[0].tolist()


def test_serve_twin_main_runs_on_cpu(capsys):
    seqs = _example("serve_hybrid_torch").main(CPU, gen=4)
    out = capsys.readouterr().out
    assert seqs.shape == (4, 12) and (seqs >= 0).all()
    assert "SSM state: 2 layers x (H=16, N=16, P=32) fp32" in out
