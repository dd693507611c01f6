"""The port's ``parallel/sharding.py`` against the JAX package's, on the CPU.

JAX's ``param_shardings`` runs on its 8-virtual-device mesh over the
parameter shapes (``jax.eval_shape``: nothing is allocated for the full
config); the port's over the same configuration's ``state_dict`` shapes on
the meta device.  Every JAX leaf must map (``pipelines.convert``'s layout
rules) to a port leaf split on the same axis over the same number of
ranks, or both whole.  Then the bytes a rank holds and the chunks' round
trip, in one process (the ranks' own round trip over gloo is in
``test_torch_tensor_parallel.py``).
"""
import dataclasses
import functools

import jax
import pytest
import torch

import _torch_tp_worker as TW
from styletts_zs_tpu.parallel import mesh as j_mesh
from styletts_zs_tpu.parallel import sharding as j_sharding
from styletts_zs_tpu.pipelines.factory import init_params as j_init_params
from styletts_zs_tpu.utils import config as j_config
from styletts_zs_torch.config import Config, tiny_test_config, to_dict
from styletts_zs_torch.parallel import sharding
from styletts_zs_torch.pipelines.convert import jax_layout
from styletts_zs_torch.pipelines.factory import _modules

G_PARTS = ("acoustic", "vocoder")
MB = 1e6


def jax_config(cfg: Config):
    """The JAX package's config with the same fields as the port's."""
    return j_config._from_dict(j_config.Config, to_dict(cfg))


def port_shapes(cfg: Config, parts) -> dict:
    """``{part: state_dict}`` of meta tensors: the shapes, no storage."""
    with torch.device("meta"):
        return {p: m.state_dict() for p, m in _modules(cfg, parts).items()}


@functools.lru_cache(maxsize=None)
def jax_shapes(cfg: Config):
    """JAX's parameter shapes with the discriminator."""
    return jax.eval_shape(lambda: j_init_params(
        jax_config(cfg), jax.random.PRNGKey(0), with_discriminator=True))


@functools.lru_cache(maxsize=None)
def jax_rule(cfg: Config, m: int, min_shard_dim: int) -> dict:
    """``{part: {port key: (torch dim, ranks) | None}}`` from JAX's
    ``param_shardings`` on a (8 // m, m) mesh of its virtual devices,
    over the parameter shapes with the discriminator."""
    shapes = jax_shapes(cfg)
    mesh = j_mesh.make_mesh(data=8 // m, model=m)
    specs = j_sharding.param_shardings(shapes, mesh,
                                       min_shard_dim=min_shard_dim)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [str(k.key) for k in path]
        part, owner, leaf = keys[0], keys[2:-1], keys[-1]
        shape = shapes
        for k in keys:
            shape = shape[k]
        name, order = jax_layout(owner[-1] if owner else "", leaf,
                                 len(shape.shape))
        spec = tuple(s.spec)
        split = None
        if any(ax is not None for ax in spec):
            assert spec[-1] == j_mesh.MODEL_AXIS and len(spec) == \
                len(shape.shape)
            split = (order.index(len(shape.shape) - 1), m)
        out.setdefault(part, {})[".".join([*owner, name])] = split
    return out


def port_rule(cfg: Config, m: int, min_shard_dim: int) -> dict:
    shapes = port_shapes(cfg, ("acoustic", "diffusion", "vocoder",
                               "discriminator"))
    shs = sharding.param_shardings(shapes, m, cfg,
                                   min_shard_dim=min_shard_dim)
    return {part: {k: None if s is None else (s.dim, s.count)
                   for k, s in sd.items()} for part, sd in shs.items()}


CASES = {
    "tiny": (lambda: tiny_test_config(), 32),
    "narrow256": (lambda: TW.narrow_config(256), 256),
    "narrow512": (lambda: TW.narrow_config(512), 256),
    "full": (lambda: Config(), 256),
}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_param_shardings_equal_jax_leaf_for_leaf(case, m):
    make, min_dim = CASES[case]
    cfg = make()
    ref, got = jax_rule(cfg, m, min_dim), port_rule(cfg, m, min_dim)
    assert got.keys() == ref.keys()
    for part in ref:
        assert got[part] == ref[part], part
    # the rule is not vacuous: something is split in every case but the
    # tiny config at model 4 (its widest kernels, 256, do not divide 512)
    n_split = sum(s is not None for sd in got.values() for s in sd.values())
    assert (n_split == 0) == (case == "tiny" and m == 4), n_split


def test_narrow_config_splits_every_leaf_kind_at_model_2():
    """Width 256 at model 2: Dense and ``nn.Conv`` kernels in both parts,
    the AdaIN kernels, ``up0_kernel``, the two embedding tables, the two
    ``queries`` and ``null_prompt_tokens``; biases and norms whole."""
    got = port_rule(TW.narrow_config(256), 2, 256)
    split = {f"{p}.{k}" for p, sd in got.items() for k, s in sd.items()
             if s is not None}
    for key in ("acoustic.text_encoder.phoneme_embed.weight",
                "acoustic.prosody_encoder.prosody_embed.weight",
                "acoustic.style_extractor.queries",
                "acoustic.prompt_encoder.queries",
                "acoustic.decoder.res0.conv1", "acoustic.decoder.res0.conv2",
                "acoustic.text_encoder.conv0.Conv_0.weight",
                "acoustic.text_encoder.attn0.MLP_0.Dense_0.weight",
                "vocoder.conv_in.weight", "vocoder.up0_kernel",
                "vocoder.mrf0_0.conv0a.weight",
                "diffusion.null_prompt_tokens"):
        assert key in split, key
    assert got["acoustic"]["text_encoder.phoneme_embed.weight"] == (1, 2)
    assert got["acoustic"]["decoder.res0.conv1"] == (2, 2)
    assert got["vocoder"]["conv_in.weight"] == (0, 2)
    assert not any(k.endswith(("bias", "LayerNorm_0.weight"))
                   for k in split)
    assert "vocoder.up1_kernel" not in split


@pytest.mark.parametrize("m,expect_mb", [(1, 374.6), (2, 193.0), (4, 131.0)])
def test_estimate_bytes_of_the_full_generator_per_rank(m, expect_mb):
    """The stage-1 generator's fp32 tree on one rank: 374.6 MB in one
    process, about 193 MB at model 2 and 131 MB at model 4; each equal to
    JAX's leaf bytes with its split leaves divided by m."""
    cfg = Config()
    shapes = port_shapes(cfg, G_PARTS)
    shs = sharding.param_shardings(shapes, m, cfg)
    local = sharding.shard_params(shapes, shs)
    got = sharding.estimate_bytes(local)
    j_tree = {p: jax_shapes(cfg)[p] for p in G_PARTS}
    whole = j_sharding.estimate_bytes(j_tree)
    assert sharding.estimate_bytes(shapes) == whole
    rule = jax_rule(cfg, m, 256) if m > 1 else None
    split_bytes = sum(v.numel() * 4 for p in G_PARTS
                      for k, v in shapes[p].items()
                      if rule is not None and rule[p][k] is not None)
    assert got == whole - split_bytes + split_bytes // m
    assert abs(got / MB - expect_mb) < 1.0, got / MB


def test_shards_round_trip_bit_for_bit_and_are_fresh():
    """Every rank's chunks, concatenated on their dims, give the tree back
    bit for bit; each chunk is contiguous and owns only its own bytes."""
    cfg = TW.narrow_config(256)
    from styletts_zs_torch.pipelines.factory import init_params
    params = {p: v for p, v in init_params(cfg, seed=0, device="cpu")
              .items() if p in G_PARTS}
    m = 2
    shs = sharding.param_shardings(params, m, cfg)
    chunks = []
    for i in range(m):
        at_i = {p: {k: None if s is None else dataclasses.replace(s, index=i)
                    for k, s in sd.items()} for p, sd in shs.items()}
        chunks.append(sharding.shard_params(params, at_i))
    n_split = 0
    for p, sd in params.items():
        for k, v in sd.items():
            s = shs[p][k]
            if s is None:
                assert chunks[0][p][k] is v
                continue
            n_split += 1
            for c in chunks:
                t = c[p][k]
                assert t.is_contiguous()
                assert t.untyped_storage().nbytes() == t.numel() * 4
            assert torch.equal(torch.cat([c[p][k] for c in chunks], s.dim),
                               v)
    assert n_split > 50
    assert sharding.estimate_bytes(chunks[0]) < \
        0.6 * sharding.estimate_bytes(params)


def test_no_split_over_one_model_rank():
    cfg = Config()
    shs = sharding.param_shardings(port_shapes(cfg, G_PARTS), 1, cfg)
    assert all(s is None for sd in shs.values() for s in sd.values())
