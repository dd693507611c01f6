"""``scripts/train_pipeline.py --tiny`` at 0 steps a stage, on the parity
tests' random tree (``_torch_parity.random_tree``, its ``init_params``
replaced), in a process of its own:

    python tests/_jax_pipeline_run.py WORKDIR

writes the script's ``WORKDIR/quality_report.json`` and
``WORKDIR/trainers.json``: the ``n_steps``, ``warmup_steps`` and ``lr`` of
the config each of its three trainers was made with.  JAX on the CPU at
full fp32 matmul precision, as ``tests/conftest.py`` sets it.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

import styletts_zs_tpu.pipelines.factory as j_factory  # noqa: E402
import styletts_zs_tpu.pipelines.train as j_train  # noqa: E402
from _torch_parity import jax_tiny, random_tree, to_jax  # noqa: E402


def main() -> None:
    work = Path(sys.argv[1])
    tree = random_tree(jax_tiny(), with_discriminator=True)
    made = {}

    def spy(name, cls):
        class Spy(cls):
            def __init__(self, cfg, *a, **k):
                t = cfg.train
                made[name] = {"n_steps": t.n_steps,
                              "warmup_steps": t.warmup_steps, "lr": t.lr}
                super().__init__(cfg, *a, **k)
        setattr(j_train, name, Spy)

    for name in ("Stage1Trainer", "Stage2Trainer", "Stage3Trainer"):
        spy(name, getattr(j_train, name))
    j_factory.init_params = \
        lambda cfg, rng, with_discriminator=False: to_jax(tree)
    os.environ["STYLETTS_JAX_CACHE"] = str(work / "cache")
    sys.argv = ["train_pipeline.py", "--tiny", "--steps1", "0", "--steps2",
                "0", "--steps3", "0", "--workdir", str(work)]
    spec = importlib.util.spec_from_file_location(
        "train_pipeline", REPO / "scripts" / "train_pipeline.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main()
    (work / "trainers.json").write_text(json.dumps(made))


if __name__ == "__main__":
    main()
