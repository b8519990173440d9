"""ops/select group-descent selection: odd group counts and pad semantics.

The descent path requires the group count to divide by 8; production caps
guarantee that, but direct kernel users can pass any shape — group_topk
+inf-pads instead of silently falling back to the much slower direct
top_k."""

import numpy as np
import jax.numpy as jnp

from vettore_tpu.ops import select


def _oracle(gmin, gsel):
    order = np.argsort(gmin, axis=1, kind="stable")
    idx = order[:, :gsel]
    return np.take_along_axis(gmin, idx, axis=1), idx


class TestGroupTopkOddNg:
    def test_odd_ng_descends_and_matches_oracle(self):
        rng = np.random.default_rng(7)
        b, ng, gsel = 4, select._DIRECT_TOPK + 57, 12  # ng % 8 != 0
        gmin = rng.normal(size=(b, ng)).astype(np.float32)
        vals, idx, ok = select.group_topk(jnp.asarray(gmin), gsel, check_c=gsel)
        ovals, oidx = _oracle(gmin, gsel)
        np.testing.assert_array_equal(np.asarray(vals), ovals)
        np.testing.assert_array_equal(np.asarray(idx), oidx)
        assert np.asarray(ok).all()

    def test_pad_selection_flags_not_ok(self):
        # fewer finite groups than gsel, and the finite ones share the final
        # (pad-carrying) super-group: the inf pads are then the earliest inf
        # entries in the descent's candidate order and WILL be selected. The
        # row must flag ok=False and keep indices in gather range — even with
        # check_c=None, where the pad check is the only guard.
        b, ng, gsel = 2, select._DIRECT_TOPK + 3, 8
        gmin = np.full((b, ng), np.inf, dtype=np.float32)
        gmin[:, ng - 3:] = [[0.0, 1.0, 2.0]] * b
        vals, idx, ok = select.group_topk(jnp.asarray(gmin), gsel, check_c=None)
        idx = np.asarray(idx)
        assert (idx < ng).all()  # indices stay in range for the gather
        assert not np.asarray(ok).any()
        # the finite groups are still all covered
        assert {ng - 3, ng - 2, ng - 1} <= set(idx[0].tolist())
        np.testing.assert_array_equal(np.asarray(vals)[:, :3],
                                      [[0.0, 1.0, 2.0]] * b)

    def test_multiple_of_8_path_unchanged(self):
        rng = np.random.default_rng(11)
        b, ng, gsel = 3, select._DIRECT_TOPK + 64, 16
        gmin = rng.normal(size=(b, ng)).astype(np.float32)
        vals, idx, ok = select.group_topk(jnp.asarray(gmin), gsel, check_c=gsel)
        ovals, oidx = _oracle(gmin, gsel)
        np.testing.assert_array_equal(np.asarray(vals), ovals)
        np.testing.assert_array_equal(np.asarray(idx), oidx)
        assert np.asarray(ok).all()
