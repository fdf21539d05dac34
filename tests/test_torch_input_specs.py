"""``repro_torch.launch.input_specs`` against the reference's
``repro.launch.input_specs``: for every ``ARCH_IDS`` entry at every shape
of ``shapes_for`` (full size, llama3-405b's training state included), each
leaf of the port's input tuple is a ``meta`` tensor (nothing allocated)
whose shape and dtype equal the reference's ``jax.eval_shape`` leaf.

The port keeps a model's layers as separate parameters
(``layers.<i>.attn.wq``) where the reference stacks them on a leading
axis (``layers.attn.wq``), as ``interop.params_from_numpy`` maps them; the
comparison stacks the port's layers the same way.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import shapes_for as jshapes_for
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import input_specs as JIS
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 shapes_for)
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import input_specs as IS
from repro_torch.models import model as LM

CELLS = [(arch, s.name) for arch in ARCH_IDS
         for s in shapes_for(get_config(arch))]
_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int32: jnp.int32}
_LAYER = re.compile(r"(^|\.)layers\.(\d+)\.")


def _ref_leaves(tree):
    """{dotted path: (shape, dtype)} of the reference's abstract tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path]
        out[".".join(keys)] = (tuple(leaf.shape), jnp.dtype(leaf.dtype))
    return out


def _port_tensors(node, prefix=""):
    """(dotted path, tensor) of the port's input tree: dicts, tuples and
    named tuples by key, field or index, a params tree by its parameter
    names."""
    if isinstance(node, torch.Tensor):
        yield prefix.rstrip("."), node
    elif isinstance(node, torch.nn.Module):
        for name, p in node.named_parameters():
            yield prefix + name, p
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _port_tensors(v, f"{prefix}{k}.")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for k in node._fields:
            yield from _port_tensors(getattr(node, k), f"{prefix}{k}.")
    elif isinstance(node, tuple):
        for i, v in enumerate(node):
            yield from _port_tensors(v, f"{prefix}{i}.")
    else:
        raise TypeError(f"{prefix}: {type(node)}")


def _port_leaves(tree):
    """{dotted path: (shape, dtype)} of the port's tree with its layers
    stacked on a leading axis, as the reference's; every leaf is on
    ``meta``."""
    layers = {}
    out = {}
    for path, t in _port_tensors(tree):
        assert t.is_meta, f"{path} is on {t.device}, not meta"
        m = _LAYER.search(path)
        if m is None:
            out[path] = (tuple(t.shape), jnp.dtype(_DTYPES[t.dtype]))
            continue
        stacked = path[:m.start()] + m.group(1) + "layers." + path[m.end():]
        layers.setdefault(stacked, {})[int(m.group(2))] = t
    for path, by_layer in layers.items():
        shapes = {tuple(t.shape) for t in by_layer.values()}
        dtypes = {t.dtype for t in by_layer.values()}
        assert sorted(by_layer) == list(range(len(by_layer))), path
        assert len(shapes) == 1 and len(dtypes) == 1, (path, shapes, dtypes)
        out[path] = ((len(by_layer),) + shapes.pop(),
                     jnp.dtype(_DTYPES[dtypes.pop()]))
    return out


@pytest.mark.parametrize("arch,shape_name", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_reference_leaf_for_leaf(arch, shape_name):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshape = {s.name: s for s in jshapes_for(jcfg)}[shape_name]
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    want = _ref_leaves(JIS.input_specs(jcfg, jshape))
    got = _port_leaves(IS.input_specs(cfg, shape))
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_train_specs_with_microbatches_and_error_feedback(compression):
    """The leading microbatch axis, the vision frontend's patch embeddings
    and the int8 error-feedback residuals, at a smoke size."""
    jcfg, cfg = jget_smoke("paligemma-3b"), get_smoke_config("paligemma-3b")
    want = _ref_leaves(JIS.input_specs(
        jcfg, JShapeConfig("t", 64, 8, "train"),
        JTrainConfig(microbatches=4, grad_compression=compression)))
    got = _port_leaves(IS.input_specs(
        cfg, ShapeConfig("t", 64, 8, "train"),
        TrainConfig(microbatches=4, grad_compression=compression)))
    assert got == want
    assert got["1.patch_embeds"] == ((4, 2, cfg.n_patches, cfg.d_model),
                                     jnp.dtype(jnp.bfloat16))
    assert got["1.tokens"][0] == (4, 2, 64 - cfg.n_patches)
    assert ("0.ef.embed" in got) == (compression == "int8_ef")


def test_decode_cache_is_filled_to_seq_len_minus_one(monkeypatch):
    """The decode cache counts S - 1 tokens resident, as the reference's
    (``pos`` is a meta scalar, so the fill is read at ``init_cache``)."""
    calls = []
    real = IS.init_cache

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(IS, "init_cache", spy)
    cfg = get_smoke_config("glm4-9b")
    cache, tokens = IS.decode_inputs(cfg, ShapeConfig("d", 32, 2, "decode"))
    assert calls == [((cfg, 2, 32), {"fill": 31, "device": IS.META})]
    assert cache["pos"].is_meta and cache["pos"].dtype == torch.int32
    assert tokens.shape == (2,) and tokens.dtype == torch.int32


def test_meta_params_allocate_nothing_and_cpu_bits_are_unchanged():
    """``init_params`` on ``meta`` draws nothing (the global generator's
    state stays put) and every leaf of llama3-405b's full size is a meta
    tensor; the CPU weights from a seed are bit for bit the same before
    and after."""
    cfg = get_smoke_config("hymba-1.5b")
    a = LM.init_params(cfg, 3, "cpu")
    torch.manual_seed(0)
    state = torch.random.get_rng_state()
    meta = LM.init_params(get_config("llama3-405b"), 3, "meta")
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(p.is_meta for p in meta.parameters())
    b = LM.init_params(cfg, 3, "cpu")
    for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), k
    assert np.isclose(sum(p.numel() for p in meta.parameters()),
                      get_config("llama3-405b").n_params, rtol=0.01)
