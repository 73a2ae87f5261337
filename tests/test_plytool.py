"""plytool (reference cmd/plytool.cpp): info/cat/displace/split."""
import numpy as np

from pbrt_jax.cmd import plytool
from pbrt_jax.scene import plyio
from pbrt_jax.utils import image as pimg


def _quad_mesh(tmp_path, name="m.ply"):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = v[:, :2].copy()
    p = str(tmp_path / name)
    plyio.write_ply(p, v, f, uvs=uv)
    return p


def test_info_and_cat(tmp_path, capsys):
    p = _quad_mesh(tmp_path)
    assert plytool.main(["info", p]) == 0
    out = capsys.readouterr().out
    assert "Triangles: 2" in out and "Vertex positions: 4" in out
    assert plytool.main(["cat", p]) == 0
    out = capsys.readouterr().out
    assert "Triangle: 0 1 2" in out


def test_refine_splits_long_edges():
    p = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float64)
    tri = np.array([[0, 1, 2]])
    pp, nn, uu, tt = plytool.refine(p, None, None, tri, max_edge=1.1)
    # every output edge must be < 1.1
    e = pp[tt]
    for a, b in [(0, 1), (1, 2), (2, 0)]:
        d = np.linalg.norm(e[:, a] - e[:, b], axis=1)
        assert np.all(d < 1.1)
    # area preserved
    def area(P, T):
        x = P[T]
        return 0.5 * np.abs(np.cross(x[:, 1] - x[:, 0],
                                     x[:, 2] - x[:, 0])[:, 2]).sum()
    assert np.isclose(area(pp.astype(np.float64), tt), 2.0)


def test_displace_moves_vertices(tmp_path):
    p = _quad_mesh(tmp_path)
    # constant 0.5 displacement map
    dmap = str(tmp_path / "d.exr")
    pimg.write_exr(dmap, np.full((4, 4, 3), 0.5, np.float32))
    out = str(tmp_path / "out.ply")
    assert plytool.main(["displace", p, "--image", dmap, "--outfile", out,
                         "--scale", "2.0", "--edge-length", "0.6"]) == 0
    m = plyio.read_ply(out)
    # flat quad in z=0 with +z normals displaced by 0.5*2 = 1.0
    assert len(m["vertices"]) > 4  # refined
    np.testing.assert_allclose(m["vertices"][:, 2], 1.0, atol=1e-5)


def test_split_chunks(tmp_path, capsys):
    v = np.random.RandomState(0).rand(30, 3).astype(np.float32)
    f = np.arange(30, dtype=np.int32).reshape(10, 3)
    p = str(tmp_path / "big.ply")
    plyio.write_ply(p, v, f)
    assert plytool.main(["split", p, "--maxfaces", "4",
                         "--outbase", str(tmp_path / "chunk")]) == 0
    parts = [plyio.read_ply(str(tmp_path / f"chunk-{k}.ply"))
             for k in range(3)]
    assert sum(len(m["indices"]) for m in parts) == 10
    # geometry preserved: triangle vertex sets match
    orig = {tuple(sorted(map(tuple, v[t]))) for t in f}
    got = set()
    for m in parts:
        for t in m["indices"]:
            got.add(tuple(sorted(map(tuple, m["vertices"][t]))))
    assert got == orig
