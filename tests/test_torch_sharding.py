"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), on shapes only: no ranks, no
tensors.

For every architecture of the registry, every parameter leaf at its full
size (``jax.eval_shape`` of the JAX init, laid out as the port's flat
per-layer list), on abstract meshes (16, 16) and (2, 2) of ("data",
"model") and the (4, 8, 8) GQA serve mesh of ("data", "kvg", "model"):
the port's placements equal the reference's PartitionSpec with the
layer-stack (scan) dim of ``stack.body`` dropped, translated to one
placement per mesh axis (``Shard(i)`` where the spec puts the axis on dim
i, else ``Replicate()``). The same for ``serve_decode`` and
``serve_tp_only``, the AdamW state, the train batch and the serving cache
at (B 8, L 4096) (and ``shard_seq``). Every ``Shard(i)`` divides its axes.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "kvg": ((4, 8, 8), ("data", "kvg", "model"))}
ARCHS = list_archs()


def test_registry_is_the_reference_one():
    assert sorted(ARCHS) == sorted(jlist_archs()) and len(ARCHS) == 13


def _abstract_mesh(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), dict(zip(axes, sizes))


@functools.lru_cache(maxsize=None)
def _shapes(arch, cache=False):
    cfg = jget_config(arch)
    if cache:
        return jax.eval_shape(lambda: JM.init_cache(cfg, 8, 4096))
    return jax.eval_shape(lambda k: JM.init_params(k, cfg),
                          jax.random.PRNGKey(0))


class _S:
    """A leaf of the port's tree: its shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _port_layout(tree, cfg, leaf_fn, *, cache=False):
    """The JAX tree in the port's layout (``convert.params_from_jax``):
    ``stack.prefix`` layers, then for each repeat r every ``stack.body``
    entry at index r, as one flat ``layers`` list (the cache: just that
    list). ``leaf_fn(path, leaf, body)`` makes each port leaf from the JAX
    leaf at ``path``."""
    def sub(node, path, body):
        if isinstance(node, dict):
            return {k: sub(v, path + (jax.tree_util.DictKey(k),), body)
                    for k, v in node.items()}
        return leaf_fn(path, node, body)

    key = jax.tree_util.DictKey
    seq = jax.tree_util.SequenceKey
    stack = tree if cache else tree["stack"]
    root = () if cache else (key("stack"),)
    layers = [sub(p, root + (key("prefix"), seq(i)), False)
              for i, p in enumerate(stack["prefix"])]
    for _ in range(cfg.num_repeats):
        for j in range(len(cfg.block_pattern)):
            layers.append(sub(stack["body"][j],
                              root + (key("body"), seq(j)), True))
    if cache:
        return layers
    out = {"embed": sub(tree["embed"], (key("embed"),), False),
           "layers": layers,
           "final_norm": sub(tree["final_norm"], (key("final_norm"),),
                             False)}
    if "lm_head" in tree:
        out["lm_head"] = sub(tree["lm_head"], (key("lm_head"),), False)
    return out


def _shape_leaf(path, leaf, body):
    return _S(leaf.shape[1:] if body else leaf.shape)


def _placements(spec, nd, axes, off):
    """The reference's PartitionSpec -> one placement per mesh axis, the
    first ``off`` (scan) dims dropped."""
    spec = list(spec) + [None] * (nd - len(spec))
    assert all(s is None for s in spec[:off])
    out = []
    for a in axes:
        dims = [i - off for i, s in enumerate(spec)
                if s == a or (isinstance(s, tuple) and a in s)]
        assert len(dims) <= 1
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _check_divides(placements, shape, axes):
    for (a, n), p in zip(axes.items(), placements):
        if p.is_shard():
            shards = int(np.prod([axes[b] for b, q in zip(axes, placements)
                                  if q == p]))
            assert shape[p.dim] % shards == 0, (a, shape, placements)


def test_port_layout_is_the_converters():
    """The layout the rules are checked on is the port's own tree: on the
    smoke configs, the port's init has exactly its paths and shapes."""
    for arch in ARCHS:
        cfg_t = get_smoke_config(arch)
        jt = jax.eval_shape(lambda k: JM.init_params(
            k, jget_config(arch).reduced()), jax.random.PRNGKey(0))
        want = dict(_walk(_port_layout(jt, cfg_t, _shape_leaf)))
        got = dict(_walk(TM.init_params(cfg_t, seed=0, device="cpu")))
        assert set(want) == set(got), arch
        for path, s in want.items():
            assert s.shape == tuple(got[path].shape), (arch, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    tree = _shapes(arch)
    port = _port_layout(tree, cfg, _shape_leaf)
    n = 0
    for mesh_name in MESHES:
        jmesh, axes = _abstract_mesh(mesh_name)
        for variant in ("train", "serve_decode", "serve_tp_only"):
            def ref(path, leaf, body, variant=variant):
                spec = jshd.param_pspec(path, leaf, jmesh, jcfg,
                                        serve_decode=variant
                                        == "serve_decode")
                if variant == "serve_tp_only":
                    spec = [None if s == "data" else s for s in spec]
                return _placements(spec, leaf.ndim, list(axes), int(body))
            want = _port_layout(tree, cfg, ref)
            got = shd.params_placements(
                port, axes, cfg=cfg,
                serve_decode=variant == "serve_decode",
                serve_tp_only=variant == "serve_tp_only")
            for path, leaf in _walk(port):
                assert _at(got, path) == _at(want, path), (
                    mesh_name, variant, path)
                _check_divides(_at(got, path), leaf.shape, axes)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_placements_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    tree = _shapes(arch)
    port = _port_layout(tree, cfg, _shape_leaf)
    for mesh_name in ("16x16", "2x2"):
        jmesh, axes = _abstract_mesh(mesh_name)
        ref = jshd.opt_state_shardings(tree, jmesh, jcfg)
        got = shd.opt_state_placements(port, axes, cfg)
        assert got["step"] == _placements(ref["step"].spec, 0, list(axes), 0)
        for name in ("m", "v"):
            want = _port_layout(ref[name], cfg,
                                lambda path, sh, body: (sh, int(body)))
            for path, leaf in _walk(port):
                sh, off = _at(want, path)
                assert _at(got[name], path) == _placements(
                    sh.spec, len(leaf.shape) + off, list(axes), off), path


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    tree = _shapes(arch, cache=True)
    port = _port_layout(tree, cfg, _shape_leaf, cache=True)
    for mesh_name in MESHES:
        jmesh, axes = _abstract_mesh(mesh_name)
        for shard_seq in (False, True):
            def ref(path, leaf, body, shard_seq=shard_seq):
                spec = jshd.cache_pspec(path, leaf, jcfg, jmesh,
                                        shard_seq=shard_seq)
                return _placements(spec, leaf.ndim, list(axes), int(body))
            want = _port_layout(tree, cfg, ref, cache=True)
            got = shd.cache_placements_tree(port, cfg, axes,
                                            shard_seq=shard_seq)
            for path, leaf in _walk(port):
                assert _at(got, path) == _at(want, path), (
                    mesh_name, shard_seq, path)
                _check_divides(_at(got, path), leaf.shape, axes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_train_batch_placements_match_reference(mesh_name):
    jmesh, axes = _abstract_mesh(mesh_name)
    for has_media in (False, True):
        ref = jshd.train_batch_shardings(jmesh, has_media=has_media)
        got = shd.train_batch_placements(axes, has_media=has_media)
        assert set(got) == set(ref)
        for k, v in ref.items():
            nd = 1 if k == "advantages" else 3 if k == "media" else 2
            assert got[k] == _placements(v.spec, nd, list(axes), 0), k


def test_serve_fits_tp_only_takes_a_budget():
    for arch in ("llama3.2-1b", "granite-34b", "qwen3-moe-235b-a22b"):
        jmesh, axes = _abstract_mesh("16x16")
        for budget in (1e9, 8e9, 80e9):
            assert shd.serve_fits_tp_only(
                get_config(arch), axes, budget_bytes=budget) == \
                jshd.serve_fits_tp_only(jget_config(arch), jmesh,
                                        budget_bytes=budget)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="budget"):
            shd.serve_fits_tp_only(get_config("tiny"), {"data": 1,
                                                        "model": 1})


def test_make_mesh_refuses_a_shape_that_is_not_the_world():
    """In one process (no process group, or one of world size 1) only a
    (1, 1) mesh fits; the refusal names the ranks the shape needs, as the
    reference's does."""
    from repro_torch.launch.mesh import make_disaggregated_devices, make_mesh
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2, device_type="cpu")
    assert make_disaggregated_devices("cpu") == (torch.device("cpu"),) * 2
