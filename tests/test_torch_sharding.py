"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, leaf by leaf, on the CPU: parameter specs for every
architecture (the smoke configs and the full configs on the meta device),
train and serve, one pod and multi-pod, equal to JAX's ``PartitionSpec``
with the stacked leading entries dropped; the optimizer-state specs; the
batch and serve specs on every applicable (arch, shape) cell; and
``placements`` on small meshes."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import stack_index
from repro_torch.distributed import sharding as tshd

MODES = [(mode, mp) for mode in ("train", "serve") for mp in (False, True)]


def _jax_specs(cfg, mode, multi_pod, smoke):
    """{JAX leaf path with '.': (spec entries padded to the leaf's rank)}."""
    if smoke:
        from repro import models as jmodels
        params = jax.eval_shape(lambda k: jmodels.init(k, cfg), jax.random.PRNGKey(0))
    else:
        params = jreg.abstract_params(cfg)
    specs = jshd.param_specs(params, cfg, mode=mode, multi_pod=multi_pod)
    out = {}
    for (path, spec), leaf in zip(
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0],
            jax.tree.leaves(params)):
        key = ".".join(str(k.key) for k in path)
        out[key] = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
    return out


@pytest.mark.parametrize("mode,multi_pod", MODES)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_specs_equal_jax(arch, smoke, mode, multi_pod):
    jcfg = jreg.get_smoke(arch) if smoke else jreg.get_config(arch)
    tcfg = treg.get_smoke(arch) if smoke else treg.get_config(arch)
    want = _jax_specs(jcfg, mode, multi_pod, smoke)
    module = treg.abstract_params(tcfg)
    got = tshd.param_specs(module, tcfg, mode=mode, multi_pod=multi_pod)
    assert sorted(got) == sorted(n for n, _ in module.named_parameters())
    leaves = set()
    sharded = 0
    for name, p in module.named_parameters():
        leaf, idx = stack_index(name)
        leaves.add(leaf)
        assert len(got[name]) == p.ndim, (name, got[name], tuple(p.shape))
        assert got[name] == want[leaf][len(idx):], (name, got[name], want[leaf])
        assert all(s is None for s in want[leaf][:len(idx)]), (leaf, want[leaf])
        sharded += any(s is not None for s in got[name])
    assert leaves == set(want)
    assert sharded > 0
    # The same specs from the module's named tensors (the moments' keys).
    assert tshd.param_specs(dict(module.named_parameters()), tcfg, mode=mode,
                            multi_pod=multi_pod) == got


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-moe-30b-a3b", "zamba2-7b"])
def test_opt_state_specs_equal_jax(arch, multi_pod):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    from repro import models as jmodels
    params = jax.eval_shape(lambda k: jmodels.init(k, jcfg), jax.random.PRNGKey(0))
    want = jshd.opt_state_specs(params, jcfg, multi_pod=multi_pod)
    got = tshd.opt_state_specs(treg.abstract_params(tcfg), tcfg, multi_pod=multi_pod)
    assert sorted(got) == sorted(want) == ["m", "step", "v"]
    assert got["step"] == tuple(want["step"]) == ()
    assert got["m"] == got["v"] == tshd.param_specs(treg.abstract_params(tcfg), tcfg,
                                                    multi_pod=multi_pod)


def _cells():
    return [(a, s.name) for a, s in jreg.all_cells()]


def _tuple_specs(d):
    return {k: tuple(v) for k, v in d.items()}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", _cells())
def test_batch_and_serve_specs_equal_jax(arch, shape, multi_pod):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jshape, tshape = jbase.SHAPES_BY_NAME[shape], tbase.SHAPES_BY_NAME[shape]
    kw = dict(multi_pod=multi_pod)
    assert tshd.batch_specs(tcfg, tshape, **kw) == _tuple_specs(
        jshd.batch_specs(jcfg, jshape, **kw))
    assert tshd.serve_partition_axes(tshape, **kw) == jshd.serve_partition_axes(jshape, **kw)
    if not tshape.lowers_serve_step:
        return
    got_in = tshd.serve_input_specs(tcfg, tshape, **kw)
    assert got_in == _tuple_specs(jshd.serve_input_specs(jcfg, jshape, **kw))
    logits, state = tshd.serve_output_specs(tcfg, tshape, **kw)
    jlogits, jstate = jshd.serve_output_specs(jcfg, jshape, **kw)
    assert logits == tuple(jlogits) and state == _tuple_specs(jstate)
    # Every input the serve step takes has a spec, of the input's rank.
    inputs = treg.input_specs(tcfg, tshape)
    assert set(got_in) == set(inputs)
    for k, t in inputs.items():
        assert len(got_in[k]) == t.ndim, (k, got_in[k], tuple(t.shape))


class _Mesh:
    """The two attributes ``placements`` reads from a DeviceMesh."""

    def __init__(self, names):
        self.mesh_dim_names = names


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    m2 = _Mesh(("data", "model"))
    m3 = _Mesh(("pod", "data", "model"))
    assert tshd.placements(("model", "data"), m2) == (Shard(1), Shard(0))
    assert tshd.placements((None, "model"), m2) == (Replicate(), Shard(1))
    assert tshd.placements((), m2) == (Replicate(), Replicate())
    assert tshd.placements((("pod", "data"), None), m3) == (Shard(0), Shard(0), Replicate())
    assert tshd.placements((None, ("data", "model")), m3) == (Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError, match="pod"):
        tshd.placements((("pod", "data"), None), m2)
    with pytest.raises(ValueError, match="order"):
        tshd.placements((("data", "pod"),), m3)
    with pytest.raises(ValueError, match="twice"):
        tshd.placements(("data", "data"), m2)


def test_activation_constraints_are_identities_without_a_policy():
    x = torch.randn(2, 3, 4)
    tshd.clear_activation_policy()
    y = x[..., None]
    assert tshd.constrain_btd(x) is x and tshd.constrain_bthd(y, 4) is y
    tshd.set_activation_policy(dp="data", tp="model", tp_size=4)
    try:   # a plain tensor passes unchanged under a policy too
        assert tshd.constrain_btd(x) is x and tshd.constrain_bthd(y, 4) is y
    finally:
        tshd.clear_activation_policy()
    assert jshd._ACT_POLICY == {}
