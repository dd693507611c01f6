"""Shared set-up of the parity tests between the JAX package and the
PyTorch port: one tiny parameter tree made with numpy from a seed, handed
to both sides (the port through ``convert_params``)."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from styletts_zs_tpu.pipelines.factory import init_params as jax_init_params
from styletts_zs_tpu.utils.config import tiny_test_config as jax_tiny
from styletts_zs_torch.config import tiny_test_config as torch_tiny

# seconds a group of ranks (``run_group``) may take before it is killed
GROUP_TIMEOUT = 120


def leaf_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def random_tree(cfg, seed: int = 0, *, with_discriminator: bool = False):
    """Numpy weights for every leaf of ``init_params(cfg)``'s tree (with
    the discriminator's when asked for).

    Matrices ~ N(0, 1/fan_in), vectors ~ N(0, 0.1²) (LayerNorm scales
    1 + that), so no part is a zero-init identity (e.g. the AdaLN gates);
    the duration head's bias puts durations at a few frames per phoneme so
    the utterances are not empty.
    """
    shapes = jax.eval_shape(lambda: jax_init_params(
        cfg, jax.random.PRNGKey(0), with_discriminator=with_discriminator))
    rs = np.random.default_rng(seed)

    def make(path, s):
        name = leaf_name(path)
        a = rs.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) > 1:
            a /= np.sqrt(np.prod(s.shape[:-1]))
        else:
            a *= 0.1
        if name.endswith("/scale"):
            a += 1.0
        if name.endswith("duration_predictor/out/bias"):
            a[:] = 1.5
        return a

    return jax.tree_util.tree_map_with_path(make, shapes)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(x) -> torch.Tensor:
    """numpy/JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _toml_lines(d: dict, path=()) -> list[str]:
    """A nested dict of scalars and tuples as TOML tables."""
    lines, subs = [], []
    for k, v in d.items():
        if isinstance(v, dict):
            subs.append((k, v))
        elif isinstance(v, bool):
            lines.append(f"{k} = {str(v).lower()}")
        elif isinstance(v, (list, tuple)):
            lines.append(f"{k} = [{', '.join(repr(x) for x in v)}]")
        elif isinstance(v, str):
            lines.append(f'{k} = "{v}"')
        else:
            lines.append(f"{k} = {v!r}")
    out = ([f"[{'.'.join(path)}]"] if path and lines else []) + lines
    for k, v in subs:
        out += _toml_lines(v, path + (k,))
    return out


def write_tiny_config(directory: Path) -> Path:
    """The port's ``tiny_test_config()`` as a TOML file that ``load_config``
    reads back equal."""
    from styletts_zs_torch.config import load_config
    path = Path(directory) / "tiny.toml"
    path.write_text("\n".join(_toml_lines(dataclasses.asdict(
        torch_tiny()))) + "\n")
    assert load_config(str(path)) == torch_tiny()
    return path


def run_cli(args: list[str], config: Path, workdir: Path):
    """``python -m styletts_zs_torch.cli train`` with ``args`` in a fresh
    process on one thread, no card visible."""
    return run_module("styletts_zs_torch.cli",
                      ["train", *args, "--config", str(config),
                       "--workdir", str(workdir)])


def jax_synth_report(level: int, monkeypatch):
    """JAX's level-``level`` report from its own ``_synth_report``, with
    ``init_params``, the program and ``_measure`` stubbed: (report, the
    keyword arguments its program was made with)."""
    import styletts_zs_tpu.pipelines.factory as j_factory
    import styletts_zs_tpu.pipelines.infer as j_infer
    from styletts_zs_tpu.pipelines import acceptance as j_acc

    made = {}

    class Out:
        def __init__(self, batch, n_frames, n_mels):
            self.mel = np.zeros((batch, n_frames, n_mels), np.float32)

    def make_synthesis_fn(cfg, **kw):
        made.update(kw, n_mels=cfg.model.audio.n_mels)
        return lambda *args: None

    def measure(fn, args):
        B = args[1].shape[0]
        wav = np.zeros((B, 100), np.float32) if made["with_vocoder"] else None
        return (Out(B, made["n_frames"], made["n_mels"]), wav), 1.0, (1.0, 1.0)

    monkeypatch.setattr(j_factory, "init_params", lambda cfg, rng: None)
    monkeypatch.setattr(j_infer, "make_synthesis_fn", make_synthesis_fn)
    monkeypatch.setattr(j_acc, "_measure", measure)
    return j_acc.run_acceptance(level, full_size=False), made


def load_chip_smoke():
    """``chip_smoke.py`` as a module (its checks, rehearsed on the CPU)."""
    import importlib.util
    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  repo / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_module(module: str, args: list[str], *, timeout: int = 300):
    """``python -m module args`` in a fresh process on one thread, no card
    visible, JAX on the CPU at full fp32 precision."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               JAX_DEFAULT_MATMUL_PRECISION="highest")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=repo,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def run_group(n: int, *, script: list[str], hosts: int,
              timeout: int = GROUP_TIMEOUT, retried: bool = False
              ) -> list[str]:
    """``script`` (argv after the interpreter) as ``n`` ranks of one
    process group on this machine (torchrun's environment, no card
    visible), the ranks spread over ``hosts`` hosts (``GROUP_RANK``) in
    blocks; fails the test, killing every rank, when the group takes more
    than ``timeout`` seconds or a rank fails.  Returns each rank's
    stdout."""
    import time

    import pytest
    from styletts_zs_torch.parallel.mesh import free_port
    repo = Path(__file__).resolve().parent.parent
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=str(repo), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r % (n // hosts)),
                   GROUP_RANK=str(r // (n // hosts)),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, *script], cwd=repo, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs, errs = [], []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            o, e = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(o)
            errs.append(e)
        failed = [e for p, e in zip(procs, errs) if p.returncode]
        if failed and not retried and any(
                "address already in use" in e.lower() for e in failed):
            # another process took the free port first: once more
            return run_group(n, script=script, hosts=hosts, timeout=timeout,
                             retried=True)
        assert not failed, f"rank failed:\n{failed[0][-3000:]}"
    except subprocess.TimeoutExpired:
        pytest.fail(f"a group of {n} ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


__all__ = ["jax_tiny", "torch_tiny", "random_tree", "to_jax", "t", "n",
           "leaf_name", "write_tiny_config", "run_cli", "jax_synth_report",
           "load_chip_smoke", "run_module", "run_group"]
