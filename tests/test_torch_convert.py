"""``convert_params`` maps every leaf of the JAX parameter tree onto the
port's modules, with the layouts the port expects, and leaves none unused."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_tiny, leaf_name, random_tree, torch_tiny
from styletts_zs_tpu.utils import config as j_config
from styletts_zs_torch import config as t_config
from styletts_zs_torch.pipelines.convert import convert_params
from styletts_zs_torch.pipelines.factory import _modules, init_params


def _variant(mod, **decoder):
    base = mod.tiny_test_config()
    return dataclasses.replace(base, model=dataclasses.replace(
        base.model, decoder=dataclasses.replace(base.model.decoder, **decoder)))


CONFIGS = {"tiny": ({}, ), "deeper_decoder": ({"n_blocks": 4, "attn_every": 1},)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_leaf_is_mapped_and_none_unused(name):
    kw = CONFIGS[name][0]
    jcfg, tcfg = _variant(j_config, **kw), _variant(t_config, **kw)
    tree = random_tree(jcfg)
    params = convert_params(tree, tcfg)
    n_leaves = {part: len(jax.tree.leaves(tree[part])) for part in params}
    for part, mod in _modules(tcfg).items():
        sd = mod.state_dict()
        assert set(params[part]) == set(sd), part
        assert len(params[part]) == n_leaves[part], part
        for k, v in sd.items():
            assert tuple(params[part][k].shape) == tuple(v.shape), k
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    assert sum(x.numel() for sd in params.values() for x in sd.values()) \
        == n_jax
    # the port's own seeded init fills the same tree
    own = init_params(tcfg, seed=0, device="cpu")
    assert {p: set(sd) for p, sd in own.items()} == \
        {p: set(sd) for p, sd in params.items()}


def test_layouts():
    tree = random_tree(jax_tiny())
    params = convert_params(tree, torch_tiny())
    ac, vo = tree["acoustic"]["params"], tree["vocoder"]["params"]
    pa, pv = params["acoustic"], params["vocoder"]
    qkv = ac["decoder"]["attn1"]["SelfAttention_0"]["qkv"]["kernel"]
    np.testing.assert_array_equal(pa["decoder.attn1.SelfAttention_0.qkv.weight"], qkv.T)
    conv = ac["text_encoder"]["conv0"]["Conv_0"]["kernel"]            # (K, in, out)
    np.testing.assert_array_equal(pa["text_encoder.conv0.Conv_0.weight"],
                                  conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(pa["decoder.res0.conv1"], ac["decoder"]["res0"]["conv1"])
    np.testing.assert_array_equal(pv["up0_kernel"], vo["up0_kernel"])
    np.testing.assert_array_equal(pv["istft_head.kernel"], vo["istft_head"]["kernel"])
    np.testing.assert_array_equal(pa["text_encoder.phoneme_embed.weight"],
                                  ac["text_encoder"]["phoneme_embed"]["embedding"])
    np.testing.assert_array_equal(pa["decoder.LayerNorm_0.weight"],
                                  ac["decoder"]["LayerNorm_0"]["scale"])


def test_unmapped_missing_or_misshaped_leaves_raise():
    tree = random_tree(jax_tiny())
    tcfg = torch_tiny()
    extra = jax.tree.map(lambda x: x, tree)
    extra["vocoder"]["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        convert_params(extra, tcfg)
    missing = jax.tree.map(lambda x: x, tree)
    del missing["vocoder"]["params"]["up1_kernel"]
    with pytest.raises(KeyError, match="up1_kernel"):
        convert_params(missing, tcfg)
    bad = jax.tree.map(lambda x: x, tree)
    bad["vocoder"]["params"]["up0_kernel"] = np.zeros((3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="up0_kernel"):
        convert_params(bad, tcfg)
    assert leaf_name((jax.tree_util.DictKey("a"), jax.tree_util.DictKey("b"))) == "a/b"
