"""Mesh comparison for the port's mesh tests: two meshes are the same when
they have the same faces up to a renumbering of the vertices and matched
vertices lie within a tolerance. The marching weld numbers vertices in the
sorted order of their coordinates rounded to 1e-6, so two vertices that
differ in the last float32 bits may swap places; and a triangle whose
orientation test (its normal against the field's gradient) is within
float32 noise of zero may come out reversed, as happens where a truncated
TSDF is flat."""
import numpy as np
from scipy.spatial import cKDTree


def assert_same_mesh(v, f, v_ref, f_ref, atol, reversed_frac=0.0):
    """v, f against v_ref, f_ref: equal counts, each vertex within atol of
    its own match in the reference (a one-to-one map), and the faces equal
    face by face once mapped, but for at most reversed_frac of them that
    hold the same vertices in the reverse order."""
    assert v.shape == v_ref.shape and f.shape == f_ref.shape, (
        v.shape, v_ref.shape, f.shape, f_ref.shape)
    if not len(v):
        return
    d, match = cKDTree(v_ref).query(v)
    assert d.max() <= atol, d.max()
    assert len(np.unique(match)) == len(match), "vertex map not one-to-one"
    mapped = match[f]
    differ = (mapped != f_ref).any(axis=1)
    np.testing.assert_array_equal(mapped[differ][:, ::-1], f_ref[differ])
    assert differ.sum() <= reversed_frac * len(f), (differ.sum(), len(f))
