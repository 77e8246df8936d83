"""dpcheck on the port: its static analyzer held against the reference's.

Every rule family but DPC501 (donation, which has no torch counterpart)
gets twin fixtures written under tmp_path: a jax snippet for the
reference's ``repro.analysis.dpcheck.run`` and its torch counterpart for
``repro_torch.analysis.dpcheck.run``, line for line. Both analyzers must
give the same rule IDs on the same lines (file names compared, since the
twins live under src/repro/ and src/repro_torch/), for the seeded-bad
snippets and the clean ones. Then the port's own additions (the kernel
entry points as samplers, the torch host syncs, CPU-only branches, a
seeded sync in a copy of the real drivers), the core's suppressions,
baseline and filter_new on the same files, the CLI's exit codes, the
self-scan of the port with no baseline, every `# dpcheck: ignore` mark of
the port suppressing a real finding, and the seeded key reuse caught by
both halves.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import repro.analysis.dpcheck as jdc
import repro_torch.analysis.dpcheck as tdc
from repro_torch import random

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BAD_REUSE = {"jax": """
    import jax

    def draw(key):
        a = jax.random.normal(key, (2,))
        b = jax.random.laplace(key, (2,))
        return a + b
""", "torch": """
    from repro_torch import random

    def draw(key):
        a = random.normal(key, (2,))
        b = random.laplace(key, (2,))
        return a + b
"""}

# name -> (jax snippet, torch snippet, file under tmp_path: "{pkg}" is repro
# or repro_torch); each pair is line for line
KEY_TWINS = {
    "dpc101_double_consume": (BAD_REUSE["jax"], BAD_REUSE["torch"], "snippet.py"),
    "dpc101_split_ok": ("""
        import jax

        def draw(key):
            ka, kb = jax.random.split(key)
            a = jax.random.normal(ka, (2,))
            b = jax.random.laplace(kb, (2,))
            return a + b
    """, """
        from repro_torch import random

        def draw(key):
            ka, kb = random.split(key)
            a = random.normal(ka, (2,))
            b = random.laplace(kb, (2,))
            return a + b
    """, "snippet.py"),
    "dpc101_loop_invariant_key": ("""
        import jax

        def draw(key, n):
            out = []
            for i in range(n):
                out.append(jax.random.normal(key, (2,)))
            return out
    """, """
        from repro_torch import random

        def draw(key, n):
            out = []
            for i in range(n):
                out.append(random.normal(key, (2,)))
            return out
    """, "snippet.py"),
    "dpc101_loop_fresh_key_ok": ("""
        import jax

        def draw(key, n):
            out = []
            for k in jax.random.split(key, n):
                out.append(jax.random.normal(k, (2,)))
            return out
    """, """
        from repro_torch import random

        def draw(key, n):
            out = []
            for k in random.split(key, n):
                out.append(random.normal(k, (2,)))
            return out
    """, "snippet.py"),
    "dpc102_parent_used_after_split": ("""
        import jax

        def draw(key):
            ks = jax.random.split(key, 3)
            return jax.random.normal(key, (2,))
    """, """
        from repro_torch import random

        def draw(key):
            ks = random.split(key, 3)
            return random.normal(key, (2,))
    """, "snippet.py"),
    "dpc102_rebound_parent_ok": ("""
        import jax

        def draw(key):
            key, sub = jax.random.split(key)
            return jax.random.normal(key, (2,))
    """, """
        from repro_torch import random

        def draw(key):
            key, sub = random.split(key)
            return random.normal(key, (2,))
    """, "snippet.py"),
    "dpc103_constant_seed_library": ("""
        import jax

        def setup():
            return jax.random.PRNGKey(0)
    """, """
        from repro_torch import random

        def setup():
            return random.PRNGKey(0)
    """, "src/{pkg}/thing.py"),
    "dpc103_constant_seed_bench_ok": ("""
        import jax

        def setup():
            return jax.random.PRNGKey(0)
    """, """
        from repro_torch import random

        def setup():
            return random.PRNGKey(0)
    """, "benchmarks/thing.py"),
    "dpc104_opaque_key_expression": ("""
        import jax

        def draw(seed):
            return jax.random.normal(make_key(seed), (2,))
    """, """
        from repro_torch import random

        def draw(seed):
            return random.normal(make_key(seed), (2,))
    """, "snippet.py"),
    "dpc104_derived_key_ok": ("""
        import jax

        def draw(key, i):
            return jax.random.normal(jax.random.fold_in(key, i), (2,))
    """, """
        from repro_torch import random

        def draw(key, i):
            return random.normal(random.fold_in(key, i), (2,))
    """, "snippet.py"),
    "dpc105_double_escape": ("""
        import jax

        def round(key, x):
            a = helper_one(x, key)
            b = helper_two(x, key)
            return a + b
    """, """
        from repro_torch import random

        def round(key, x):
            a = helper_one(x, key)
            b = helper_two(x, key)
            return a + b
    """, "snippet.py"),
    "dpc105_fold_in_handoff_ok": ("""
        import jax

        def round(key, x):
            a = helper_one(x, jax.random.fold_in(key, 0))
            b = helper_two(x, jax.random.fold_in(key, 1))
            return a + b
    """, """
        from repro_torch import random

        def round(key, x):
            a = helper_one(x, random.fold_in(key, 0))
            b = helper_two(x, random.fold_in(key, 1))
            return a + b
    """, "snippet.py"),
    "dpc204_hot_loop_element_sync": ("""
        import jax

        def drive(fed, state):
            seq = jax.random.randint(jax.random.PRNGKey(0), (8,), 0, 4)
            for i in range(8):
                state = fed.step(state, int(seq[i]))
            return state
    """, """
        from repro_torch import random

        def drive(fed, state):
            seq = random.randint(random.PRNGKey(0), (8,), 0, 4)
            for i in range(8):
                state = fed.step(state, int(seq[i]))
            return state
    """, "benchmarks/bench_x.py"),
    "dpc204_hoisted_ok": ("""
        import jax
        import numpy as np

        def drive(fed, state):
            seq = np.asarray(
                jax.random.randint(jax.random.PRNGKey(0), (8,), 0, 4))
            for i in range(8):
                state = fed.step(state, int(seq[i]))
            return state
    """, """
        from repro_torch import random
        import numpy as np

        def drive(fed, state):
            seq = random.randint(
                random.PRNGKey(0), (8,), 0, 4).tolist()
            for i in range(8):
                state = fed.step(state, int(seq[i]))
            return state
    """, "benchmarks/bench_x.py"),
    "dpc301_noise_before_clip": ("""
        import jax
        import jax.numpy as jnp

        def privatize(g, key, xi, scale):
            noisy = g + scale * jax.random.laplace(key, g.shape)
            norm = jnp.linalg.norm(noisy)
            return noisy * jnp.minimum(1.0, xi / norm)
    """, """
        import torch
        from repro_torch import random

        def privatize(g, key, xi, scale):
            noisy = g + scale * random.laplace(key, g.shape)
            norm = torch.linalg.norm(noisy)
            return noisy * torch.minimum(1, xi / norm)
    """, "snippet.py"),
    "dpc301_clip_then_noise_ok": ("""
        import jax
        import jax.numpy as jnp

        def privatize(g, key, xi, scale):
            norm = jnp.linalg.norm(g)
            g = g * jnp.minimum(1.0, xi / norm)
            return g + scale * jax.random.laplace(key, g.shape)
    """, """
        import torch
        from repro_torch import random

        def privatize(g, key, xi, scale):
            norm = torch.linalg.norm(g)
            g = g * torch.minimum(1, xi / norm)
            return g + scale * random.laplace(key, g.shape)
    """, "snippet.py"),
}

# DPC302: the same body under both packages, jnp.where <-> torch.where
GRANT_TWINS = {
    "dpc302_unmasked_bank_write": """
        def round(led, bank, new_i, owner_idx, theta):
            ok = led.authorized(owner_idx)
            theta = {np}.where(ok, theta, theta * 0)
            return _write_bank(bank, new_i, owner_idx)
    """,
    "dpc302_masked_write_ok": """
        def round(led, bank, new_i, old_i, owner_idx):
            ok = led.authorized(owner_idx)
            masked = {np}.where(ok, new_i, old_i)
            return _write_bank(bank, masked, owner_idx)
    """,
    "dpc302_fault_guard_masks_ok": """
        def round(led, fs, bank, new_i, old_i, owner_idx, corrupt):
            auth = led.authorized(owner_idx) & ~fs.quarantined[owner_idx]
            good = verify_row(fs.checksum, bank, owner_idx, corrupt)
            good = good & finite_guard(new_i)
            grant = auth & good
            masked = {np}.where(grant, new_i, old_i)
            return _write_bank(bank, masked, owner_idx)
    """,
    "dpc302_deadline_guard_ok": """
        def round(led, fs, bank, new_i, old_i, owner_idx, fcode):
            auth = led.authorized(owner_idx) & ~fs.quarantined[owner_idx]
            on_time = deadline_guard(fcode)
            grant = auth & on_time & finite_guard(new_i)
            masked = {np}.where(grant, new_i, old_i)
            return _write_bank(bank, masked, owner_idx)
    """,
    "dpc302_homemade_deadline_mask": """
        def round(led, bank, new_i, old_i, owner_idx, lat, deadline):
            ok = led.authorized(owner_idx)
            theta = {np}.where(ok, new_i, old_i)
            on_time = lat <= deadline
            masked = {np}.where(on_time, new_i, old_i)
            return _write_bank(bank, masked, owner_idx)
    """,
    "dpc302_unrelated_mask": """
        def round(led, bank, new_i, old_i, owner_idx, mood):
            ok = led.authorized(owner_idx)
            theta = {np}.where(ok, new_i, old_i)
            masked = {np}.where(mood, new_i, old_i)
            return _write_bank(bank, masked, owner_idx)
    """,
    "dpc302_sibling_closure": """
        def make(led, bank):
            def guarded(new_i, old_i, owner_idx):
                ok = led.authorized(owner_idx)
                ok_row = {np}.where(ok, new_i, old_i)
                return _write_bank(bank, ok_row, owner_idx)

            def sneaky(new_i, owner_idx):
                ok = led.authorized(owner_idx)
                return _write_bank(bank, new_i, owner_idx)

            return guarded, sneaky
    """,
    "dpc302_residency_hit_ok": """
        def round(bank, hot, new_i, old_i, owner_idx):
            slot, hit = bank.lookup(owner_idx)
            masked = {np}.where(hit, new_i, old_i)
            return _write_bank(hot, masked, slot)
    """,
    "dpc302_residency_slot_does_not_vouch": """
        def round(led, bank, hot, new_i, old_i, owner_idx):
            ok = led.authorized(owner_idx)
            slot, hit = bank.lookup(owner_idx)
            value = {np}.where(slot >= 0, new_i, old_i)
            return _write_bank(hot, value, slot)
    """,
}

# DPC2xx: a driver module whose round body calls helpers.metric; the
# reference's scans with lax.scan, the port's loops over the rounds
SCAN_MODULE = {"jax": """
    import jax
    import jax.numpy as jnp
    from repro.federation.helpers import metric

    def make_rounds():
        def body(carry, x):
            return carry + metric(x), None

        def run(xs):
            return jax.lax.scan(body, 0.0, xs)
        return run
""", "torch": """
    import torch
    from repro_torch.federation.helpers import metric

    def make_rounds():
        def body(carry, x):
            return carry + metric(x), None

        def run(xs):
            carry = torch.zeros(())
            for k in range(xs.shape[0]):
                carry, _ = body(carry, xs[k])
            return carry
        return run
"""}
HELPER_TWINS = {
    "dpc201_host_sync_reachable": ("""
        import numpy as np

        def metric(x):
            return float(np.asarray(x).mean())
    """, """
        import torch

        def metric(x):
            return x.mean().item()
    """),
    "dpc201_stays_on_device_ok": ("""
        import jax.numpy as jnp

        def metric(x):
            return jnp.mean(x)
    """, """
        import torch

        def metric(x):
            return torch.mean(x)
    """),
    "dpc202_branch_on_traced_value": ("""
        import jax.numpy as jnp

        def metric(x):
            m = jnp.mean(x)
            if m > 0:
                return m
            return -m
    """, """
        import torch

        def metric(x):
            m = torch.mean(x)
            if m > 0:
                return m
            return -m
    """),
    "dpc202_static_config_branch_ok": ("""
        import jax.numpy as jnp

        def metric(x, fused=False):
            if fused:
                return jnp.mean(x) * 2
            return jnp.mean(x)
    """, """
        import torch

        def metric(x, fused=False):
            if fused:
                return torch.mean(x) * 2
            return torch.mean(x)
    """),
    "dpc203_print_of_traced_value": ("""
        import jax
        import jax.numpy as jnp

        def metric(x):
            m = jnp.mean(x)
            jax.debug.print("{}", m)
            return m
    """, """
        import torch


        def metric(x):
            m = torch.mean(x)
            print("mean", m)
            return m
    """),
}


def _write(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return path


def _found(violations):
    """(rule, file name, line) of each finding: the twins differ in their
    package directory only."""
    return sorted((v.rule, os.path.basename(v.path), v.line) for v in violations)


def _rules(violations):
    return sorted({v.rule for v in violations})


def _twin_runs(tmp_path, files):
    """Run each analyzer over its own twin tree: `files` maps a relative
    path (with "{pkg}") to a {"jax": src, "torch": src} pair."""
    out = {}
    for side, pkg, mod in (("jax", "repro", jdc), ("torch", "repro_torch", tdc)):
        root = tmp_path / side
        for rel, srcs in files.items():
            _write(root, rel.format(pkg=pkg), srcs[side])
        out[side] = mod.run([str(root / p.split("/")[0]) for p in
                             sorted({r.format(pkg=pkg) for r in files})], root=str(root))
    return out["jax"], out["torch"]


@pytest.mark.parametrize("name", sorted(KEY_TWINS))
def test_key_and_order_twins_agree(tmp_path, name):
    jsrc, tsrc, rel = KEY_TWINS[name]
    jv, tv = _twin_runs(tmp_path, {rel: {"jax": jsrc, "torch": tsrc}})
    assert _found(tv) == _found(jv), ([v.format() for v in jv], [v.format() for v in tv])
    assert bool(tv) == (not name.endswith("_ok"))


@pytest.mark.parametrize("name", sorted(GRANT_TWINS))
def test_grant_twins_agree(tmp_path, name):
    src = GRANT_TWINS[name]
    jv, tv = _twin_runs(tmp_path, {"snippet.py": {
        "jax": "import jax.numpy as jnp\n" + textwrap.dedent(src).format(np="jnp"),
        "torch": "import torch\n" + textwrap.dedent(src).format(np="torch")}})
    assert _found(tv) == _found(jv)
    assert _rules(tv) == ([] if name.endswith("_ok") else ["DPC302"])


@pytest.mark.parametrize("name", sorted(HELPER_TWINS))
def test_hostsync_twins_agree(tmp_path, name):
    jhelper, thelper = HELPER_TWINS[name]
    fed = "src/{pkg}/federation/"
    jv, tv = _twin_runs(tmp_path, {
        fed + "deep.py": SCAN_MODULE, fed + "convex.py": {"jax": "", "torch": ""},
        fed + "helpers.py": {"jax": jhelper, "torch": thelper}})
    assert _found(tv) == _found(jv)
    assert bool(tv) == (not name.endswith("_ok"))
    assert all(v.path.endswith("helpers.py") for v in tv)


KERNEL_FILES = {"kernel.py": "def op_2d(x):\n    return x\n",
                "ops.py": "def op_tree(t):\n    return t\n",
                "ref.py": "def op_ref(x):\n    return x\n"}


def _kernel_tree(root, pkg, files, test_name, test_src, csrc=True):
    kd = root / "src" / pkg / "kernels" / "mykern"
    kd.mkdir(parents=True, exist_ok=True)
    for name, src in files.items():
        (kd / name).write_text(src)
    if csrc:
        (kd / "csrc").mkdir(exist_ok=True)
        (kd / "csrc" / "mykern.cu").write_text("// kernel\n")
    (root / "tests").mkdir(exist_ok=True)
    (root / "tests" / test_name).write_text(test_src)
    return str(root / "src")


@pytest.mark.parametrize("files,with_test,want", [
    ({"kernel.py": KERNEL_FILES["kernel.py"]}, True, ["DPC401"]),
    (KERNEL_FILES, False, ["DPC403"]),
    (KERNEL_FILES, True, []),
], ids=["dpc401_missing_triple_member", "dpc403_no_oracle_test", "conforming_ok"])
def test_kernel_twins_agree(tmp_path, files, with_test, want):
    found = {}
    for side, pkg, mod, test_name in (("jax", "repro", jdc, "test_k.py"),
                                      ("torch", "repro_torch", tdc, "test_torch_k.py")):
        root = tmp_path / side
        src = (f"from {pkg}.kernels.mykern.ref import op_ref\n" if with_test else "import os\n")
        found[side] = mod.run([_kernel_tree(root, pkg, files, test_name, src)], root=str(root))
    assert _found(found["torch"]) == _found(found["jax"])
    assert _rules(found["torch"]) == want


def test_kernel_layout_needs_csrc_and_a_torch_test(tmp_path):
    src = _kernel_tree(tmp_path, "repro_torch", KERNEL_FILES, "test_torch_k.py",
                       "from repro_torch.kernels.mykern.ref import op_ref\n", csrc=False)
    vs = tdc.run([src], root=str(tmp_path))
    assert _rules(vs) == ["DPC401"] and "csrc/" in vs[0].message
    # a reference-side test (not tests/test_torch_*) does not hold the port's kernel
    other = tmp_path / "other"
    src = _kernel_tree(other, "repro_torch", KERNEL_FILES, "test_k.py",
                       "from repro_torch.kernels.mykern.ref import op_ref\n")
    (other / "tests" / "test_torch_other.py").write_text("import os\n")
    assert _rules(tdc.run([src], root=str(other))) == ["DPC403"]


# ---------------------- the port's own additions ---------------------------
def _scan(tmp_path, src, rel="snippet.py"):
    return tdc.run([str(_write(tmp_path, rel, src))], root=str(tmp_path))


@pytest.mark.parametrize("call,kind", [
    ("dp_round_flat(tb, acc, key, 1.0, 0.1, 0.5)", "DPC101"),
    ("scale_noise(g, key, 1.0, 0.1)", "DPC101"),
    ("tree_delta_(nodes, counts, owner, key, ns)", "DPC101"),
    ("encode_row(g, key, 'int8')", "DPC101"),
    ("dp_round_rows(tb, acc, keys=key, gain=1.0, noise_scale=0.1, w=0.5)", "DPC101"),
], ids=["dp_round_flat", "scale_noise", "tree_delta_", "encode_row", "keys_kwarg"])
def test_kernel_entry_points_are_samplers(tmp_path, call, kind):
    vs = _scan(tmp_path, f"""
        from repro_torch import random

        def round(key, g, tb, acc, nodes, counts, owner, ns):
            a = random.bits(key, (4,))
            return {call}
    """)
    assert _found(vs) == [(kind, "snippet.py", 6)]


def test_kernel_sampler_key_views_and_branches_ok(tmp_path):
    vs = _scan(tmp_path, """
        from repro_torch import random

        def round(key, g, nodes, counts, owner, ns, block, dev):
            bits = random.bits(key, g.shape) if block is None else random.bits_block(key, *block)
            ka, kb = random.split(random.fold_in(key, 1))
            d = tree_delta_(nodes, counts, owner, ka.to(dev), ns)
            return scale_noise(g, kb, 1.0, ns), bits, d
    """)
    assert vs == []


@pytest.mark.parametrize("line,rule", [
    ("return x.sum().tolist()", "DPC201"),
    ("return x.cpu()", "DPC201"),
    ("return int(torch.sum(x))", "DPC201"),
    ("return torch.nonzero(x > 0)", "DPC201"),
    ("return x[torch.isfinite(x)]", "DPC201"),
    ("torch.cuda.synchronize()", "DPC201"),
    ("return torch.where(x > 0)", "DPC201"),
    ("return 1.0 if torch.sum(x) > 0 else 0.0", "DPC202"),
    ("print(f'{torch.sum(x)}')", "DPC203"),
    ("return int(x.shape[0]) + x.numel() + (x.device.type == 'cuda')", None),
    ("return torch.where(x > 0, x, 0.0)", None),
    ("m = torch.sum(x)\n    return None if m is None else m", None),
], ids=["tolist", "cpu", "int-of-tensor", "nonzero", "bool-mask", "synchronize",
        "where-1arg", "ifexp", "print-fstring", "metadata-ok", "where-3arg-ok", "is-none-ok"])
def test_torch_host_syncs(tmp_path, line, rule):
    fed = tmp_path / "src" / "repro_torch" / "federation"
    _write(tmp_path, "src/repro_torch/federation/deep.py", SCAN_MODULE["torch"])
    _write(tmp_path, "src/repro_torch/federation/helpers.py",
           "import torch\n\n\ndef metric(x):\n    " + line + "\n")
    vs = tdc.run([str(fed)], root=str(tmp_path))
    assert _rules(vs) == ([] if rule is None else [rule])


def test_cpu_only_branch_is_not_a_host_sync(tmp_path):
    fed = tmp_path / "src" / "repro_torch" / "federation"
    _write(tmp_path, "src/repro_torch/federation/deep.py", SCAN_MODULE["torch"])
    _write(tmp_path, "src/repro_torch/federation/helpers.py", """
        import torch

        def metric(x):
            if x.device.type == "cpu":
                if torch.unique(x).numel() != x.numel():
                    raise ValueError(f"repeats in {x.tolist()}")
                return torch.mean(x)
            return torch.mean(x).item()
    """)
    vs = tdc.run([str(fed)], root=str(tmp_path))
    assert _found(vs) == [("DPC201", "helpers.py", 9)]


@pytest.mark.parametrize("module,anchor,where", [
    ("deep", "        led.spent.scatter_add_(0, owner_idx, oki.reshape(1))\n",
     "make_fused_rounds.body"),
    ("deep", "        led.spent.index_add_(0, owners, oki)\n", "make_group_rounds.body"),
    ("convex", "        qbar = q + noise_t[k]", "_steps"),
    ("convex", "        hist[:, k] = theta\n", "sync_scan_engine"),
])
def test_seeded_sync_in_the_real_round_loops_is_caught(tmp_path, module, anchor, where):
    """The round loops are found in the code: a host sync seeded into a copy
    of the drivers' K-round bodies or the convex engines' T loops is
    flagged there (the guard a CUDA-graph capture of a dispatch needs)."""
    fed = tmp_path / "src" / "repro_torch" / "federation"
    fed.mkdir(parents=True)
    for name in ("deep.py", "convex.py"):
        shutil.copy(os.path.join(REPO, "src", "repro_torch", "federation", name), fed / name)
    assert tdc.run([str(fed)], root=str(tmp_path)) == []
    path = fed / f"{module}.py"
    src = path.read_text()
    assert src.count(anchor) == 1
    indent = anchor[:len(anchor) - len(anchor.lstrip())]
    path.write_text(src.replace(anchor, anchor.rstrip("\n") + "\n" + indent
                                + "float(torch.zeros(()))\n" if anchor.endswith("\n")
                                else anchor + "\n" + indent + "float(torch.zeros(()))"))
    vs = tdc.run([str(fed)], root=str(tmp_path))
    assert _rules(vs) == ["DPC201"] and f"`{where}`" in vs[0].message, [v.format() for v in vs]


def _lines(body):
    """Statements for a snippet's function body (12 spaces in)."""
    return "\n            ".join(body)


@pytest.mark.parametrize("body,want", [
    (["new_L, new_i = dp_round_flat(tb, acc, key, gain, ns, w)",
      "acc = acc * _clip_scale(xi, norm)"], ["DPC301"]),
    (["acc = acc * _clip_scale(xi, norm)",
      "new_L, new_i = dp_round_flat(tb, acc, key, gain, ns, w)"], []),
    (["g = fused_scale_noise_tree(g, key, 1.0, ns)",
      "g = g * torch.clamp(xi / norm, max=1.0)"], []),
    (["d = tree_delta_(nodes, counts, owner, key, ns)",
      "acc = torch.minimum(1, xi / norm) * acc"], ["DPC301"]),
], ids=["kernel-noise-before-clip", "clip-then-kernel", "clamp-is-not-a-clip",
        "tree-before-minimum"])
def test_dp_order_on_the_port_entry_points(tmp_path, body, want):
    vs = _scan(tmp_path, f"""
        import torch

        def round(tb, acc, key, gain, ns, w, xi, norm, g, nodes, counts, owner):
            {_lines(body)}
            return acc
    """)
    assert _rules(vs) == want


@pytest.mark.parametrize("body,want", [
    (["slot, hit = _bank_slot(bank, owner_idx)",
      "_write_rows_(hot, slot, new_i, lay, hit)"], []),
    (["slot, hit = _bank_slot(bank, owner_idx)",
      "_write_rows_(hot, slot, new_i, lay, slot >= 0)"], ["DPC302"]),
    (["spmd.put_rows_(leaf, owner_idx, new_i)"], ["DPC302"]),
    (["spmd.put_rows_(leaf, owner_idx, _select(ok, new_i, old_i))"], []),
    (["_quant_write(hot, new_i, owner_idx, key, ok=ok, lay=lay)"], []),
], ids=["bank-slot-hit", "bank-slot-slot", "put-rows-unmasked", "put-rows-select",
        "quant-write-ok-kwarg"])
def test_grant_masks_on_the_port_writers(tmp_path, body, want):
    vs = _scan(tmp_path, f"""
        import torch

        def round(state, bank, hot, leaf, new_i, old_i, owner_idx, key, lay):
            led = state.ledger
            ok = led.authorized(owner_idx)
            {_lines(body)}
            return hot
    """)
    assert _rules(vs) == want


# ------------------- core: suppressions, baseline, CLI ---------------------
@pytest.mark.parametrize("rule,want", [("DPC101", []), ("DPC999", ["DPC101"]),
                                       ("ALL", [])])
def test_inline_suppression_agrees(tmp_path, rule, want):
    srcs = {"jax": BAD_REUSE["jax"].replace(
                "b = jax.random.laplace(key, (2,))",
                f"b = jax.random.laplace(key, (2,))  # dpcheck: ignore[{rule}]"),
            "torch": BAD_REUSE["torch"].replace(
                "b = random.laplace(key, (2,))",
                f"b = random.laplace(key, (2,))  # dpcheck: ignore[{rule}]")}
    jv, tv = _twin_runs(tmp_path, {"snippet.py": srcs})
    assert _rules(jv) == _rules(tv) == want


def test_baseline_roundtrip_agrees(tmp_path):
    more = {"jax": "\n\ndef more(key):\n    jax.random.normal(key, (2,))\n"
                   "    return jax.random.normal(key, (2,))\n",
            "torch": "\n\ndef more(key):\n    random.normal(key, (2,))\n"
                     "    return random.normal(key, (2,))\n"}
    for side, mod in (("jax", jdc), ("torch", tdc)):
        root = tmp_path / side
        bad = _write(root, "bad.py", BAD_REUSE[side])
        vs = mod.run([str(bad)], root=str(root))
        assert [v.rule for v in vs] == ["DPC101"]
        bl = root / "baseline.json"
        mod.write_baseline(str(bl), vs)
        assert mod.filter_new(vs, mod.load_baseline(str(bl))) == []
        assert mod.load_baseline(str(root / "missing.json")) == set()
        bad.write_text(textwrap.dedent(BAD_REUSE[side]) + more[side])
        vs2 = mod.run([str(bad)], root=str(root))
        assert len(mod.filter_new(vs2, mod.load_baseline(str(bl)))) == 1
        assert json.loads(bl.read_text())["version"] == 1


def _cli(cwd, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.dpcheck", *args],
                          cwd=str(cwd), env=env, capture_output=True, text=True, timeout=300)


def test_cli_json_and_exit_codes(tmp_path):
    _write(tmp_path, "bad.py", BAD_REUSE["torch"])
    r = _cli(tmp_path, "bad.py", "--format=json")
    assert r.returncode == 1
    payload = json.loads(r.stdout)
    assert payload["new_count"] == 1 and payload["violations"][0]["rule"] == "DPC101"
    r = _cli(tmp_path, "bad.py", "--baseline", "bl.json", "--write-baseline")
    assert r.returncode == 0 and (tmp_path / "bl.json").exists()
    r = _cli(tmp_path, "bad.py", "--baseline", "bl.json")
    assert r.returncode == 0 and "1 known in baseline" in r.stdout
    _write(tmp_path, "good.py", "x = 1\n")
    assert _cli(tmp_path, "good.py").returncode == 0
    r = _cli(tmp_path, "--list-rules")
    assert r.returncode == 0 and "DPC501" not in r.stdout
    assert {ln.split()[0] for ln in r.stdout.splitlines()} == set(tdc.RULE_DOCS)


def test_cli_default_paths_clean_on_the_repo():
    r = _cli(REPO)
    assert r.returncode == 0, r.stdout
    assert r.stdout.strip() == "dpcheck: 0 new violation(s), 0 total"


def test_rule_docs_are_the_reference_rules_but_donation():
    assert set(tdc.RULE_DOCS) == set(jdc.RULE_DOCS) - {"DPC501"}


# ------------------------------- self-scan ---------------------------------
def _port_paths():
    from repro_torch.analysis.dpcheck.__main__ import default_paths
    paths = default_paths(REPO)
    assert paths[:2] == ["src/repro_torch", "chip_smoke.py"]
    assert {"examples/async_dp_llm_torch.py", "examples/collaboration_forecast_torch.py",
            "examples/quickstart_torch.py", "examples/serve_hybrid_torch.py"} <= set(paths)
    return paths


def test_self_scan_port_clean_with_no_baseline():
    vs = tdc.run(_port_paths(), root=REPO)
    assert vs == [], [v.format() for v in vs]


def test_every_ignore_mark_of_the_port_suppresses_a_real_finding(monkeypatch):
    """Each `# dpcheck: ignore[...]` of the port sits on a line where the
    port's rules find R: no stale marks, and the DPC105 marks of the
    drivers and the session (the round key handed on to a codec or a
    fault draw that folds in its own salt) still silence real findings."""
    from repro_torch.analysis.dpcheck import core
    monkeypatch.setattr(core.FileCtx, "suppressed", lambda self, v: False)
    found = {(v.path, v.line, v.rule) for v in tdc.run(_port_paths(), root=REPO)}
    marks = set()
    for path in core.collect_files(_port_paths(), REPO):
        rel = os.path.relpath(path, REPO)
        with open(path, encoding="utf-8") as f:
            for line, rules in core.parse_suppressions(f.read().splitlines()).items():
                marks |= {(rel, line, r) for r in rules}
    assert marks == found
    lib = sorted((p, r) for p, _, r in marks if p.startswith("src/"))
    # the sanitizer's forwarding wrapper, the drivers' round key handed to
    # the bank write, the session's fault/latency draws and round keys
    assert lib == [("src/repro_torch/analysis/dpcheck/_sanitize.py", "DPC105")] + [
        ("src/repro_torch/federation/deep.py", "DPC105")] * 6 + [
        ("src/repro_torch/federation/session.py", "DPC105")] * 2


# ------------- seeded reuse caught by BOTH static and runtime --------------
def test_seeded_reuse_caught_by_both_halves(tmp_path):
    assert _rules(_scan(tmp_path, BAD_REUSE["torch"])) == ["DPC101"]
    ns = {}
    exec(compile(textwrap.dedent(BAD_REUSE["torch"]), "<fixture>", "exec"), ns)
    with pytest.raises(tdc.KeyReuseError):
        with tdc.sanitize():
            ns["draw"](random.PRNGKey(0, device="cpu"))
