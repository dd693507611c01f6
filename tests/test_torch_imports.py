"""The port stands alone: ``styletts_zs_torch`` and ``chip_smoke.py`` import
nothing of JAX, Flax, Orbax or the JAX package, and the entry points that
default to the card refuse to run without one."""
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

BLOCKED_RUN = textwrap.dedent('''
    import importlib.abc, importlib.util, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "styletts_zs_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import styletts_zs_torch
    mods = [m.name for m in pkgutil.walk_packages(
        styletts_zs_torch.__path__, "styletts_zs_torch.")]
    for m in mods:
        importlib.import_module(m)
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]

    import torch
    assert not torch.cuda.is_available()
    from styletts_zs_torch.config import tiny_test_config
    from styletts_zs_torch import cli
    from styletts_zs_torch import bench
    from styletts_zs_torch import graft_entry, scaling_bench
    from styletts_zs_torch.pipelines import (acceptance, factory, infer,
                                             pipeline, serve, train, verify)
    from styletts_zs_torch.parallel import mesh
    cfg = tiny_test_config()
    params = factory.init_params(cfg, device="cpu", with_discriminator=True)
    calls = {
        "init_params": lambda: factory.init_params(cfg),
        "build_models": lambda: factory.build_models(cfg, params),
        "make_synthesis_fn": lambda: infer.make_synthesis_fn(cfg, params),
        "make_fixed_style_fn": lambda: infer.make_fixed_style_fn(cfg, params),
        "Synthesizer": lambda: infer.Synthesizer(cfg, params),
        "Stage1Trainer": lambda: train.Stage1Trainer(cfg, params),
        "Stage2Trainer": lambda: train.Stage2Trainer(cfg, params),
        "Stage3Trainer": lambda: train.Stage3Trainer(cfg, params),
        "cli train": lambda: cli.main(["train", "--stage", "3"]),
        "cli verify": lambda: cli.main(["verify"]),
        "cli synth": lambda: cli.main(["synth", "--text", "hi"]),
        "cli accept": lambda: cli.main(["accept", "--level", "0"]),
        "cli bench": lambda: cli.main(["bench"]),
        "bench": lambda: bench.main([]),
        "run_acceptance": lambda: acceptance.run_acceptance(2),
        "Server": lambda: serve.Server(cfg, params),
        "run_verification": lambda: verify.run_verification(),
        "run_pipeline": lambda: pipeline.run_pipeline(),
        "pipeline main": lambda: pipeline.main(["--steps1", "1"]),
        "make_mesh": lambda: mesh.make_mesh(),
        "entry": lambda: graft_entry.entry(),
        "graft_entry main": lambda: graft_entry.main([]),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(4),
        "scaling_bench": lambda: scaling_bench.main(["--mesh", "1"]),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), (name, e)
        else:
            raise AssertionError(f"{name} ran without a card")
    print("OK", len(mods))
''')


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_and_chip_smoke_import_no_jax():
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_no_jax_in_port_sources():
    files = list((REPO / "styletts_zs_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not any(w in s.split()[1].split(".")[0] for w in
                               ("jax", "flax", "orbax", "styletts_zs_tpu")), \
                    f"{f}: {s}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       env=dict(_env(), PYTHONPATH=""), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
