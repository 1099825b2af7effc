"""Scene and State are frozen dataclasses registered as JAX pytrees
(`core.scene.pytree_dataclass`): array fields are children, `static_field`s
are treedef aux data."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moby_tpu.core import scene as sc


@sc.pytree_dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = sc.static_field(3)


def _stack():
    import bench

    return bench._stack_scene()


def test_flatten_unflatten_round_trip():
    scene, st = _stack()
    for obj in (scene, st):
        leaves, tdef = jax.tree_util.tree_flatten(obj)
        back = jax.tree_util.tree_unflatten(tdef, leaves)
        assert type(back) is type(obj)
        for x, y in zip(leaves, jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree_util.tree_unflatten(
        *reversed(jax.tree_util.tree_flatten(scene))).nb == scene.nb


def test_replace_returns_changed_copy():
    _, st = _stack()
    st2 = st.replace(time=st.time + 1.0)
    np.testing.assert_allclose(np.asarray(st2.time), np.asarray(st.time) + 1.0)
    assert st2.pos is st.pos
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.time = st.time + 1.0


def test_static_fields_are_aux_data():
    p = _Pair(a=jnp.ones(2), n=5)
    leaves, tdef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 1  # b=None is an empty subtree, n is static
    assert tdef != jax.tree_util.tree_structure(p.replace(n=6))
    assert jax.tree_util.tree_unflatten(tdef, leaves).n == 5
    scene, _ = _stack()
    assert all(isinstance(x, jax.Array)
               for x in jax.tree_util.tree_leaves(scene))
    # a static change retraces: jit keys on the treedef
    traces = []

    @jax.jit
    def f(obj):
        traces.append(obj.n)
        return obj.a * obj.n

    f(p)
    f(p.replace(a=jnp.zeros(2)))
    f(p.replace(n=7))
    assert traces == [5, 7]


def test_vmap_over_state():
    _, st = _stack()
    B = 3
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    out = jax.vmap(lambda s: s.replace(pos=s.pos * 2.0))(batched)
    assert isinstance(out, sc.State)
    assert out.pos.shape == (B,) + st.pos.shape
    np.testing.assert_allclose(np.asarray(out.pos[1]), 2.0 * np.asarray(st.pos))
