"""Second-order meshes from first-order ones, for the port's tests (no
JAX here, so the card's tests can import it): a node added per edge, and
per face and at the centre, in Gmsh order (tests/test_quadratic_io.py's
_elevate_hex, generalised)."""

import numpy as np

_HEX_EDGES = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
              (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
_HEX_FACES = [(0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
              (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7)]
_QUAD_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _elevate(coords, conn, edges, faces, centre):
    """(coords, connectivity) of a linear mesh with a node added per edge
    (and per face and at the centre) in Gmsh order, each shared node
    once, numbered in first-seen order (tests/test_quadratic_io.py's
    _elevate_hex, generalised)."""
    coords = np.asarray(coords, dtype=np.float64)
    new, key2id, rows = [coords], {}, []

    def node_at(key, pt):
        if key not in key2id:
            key2id[key] = coords.shape[0] + len(key2id)
            new.append(pt[None])
        return key2id[key]

    for e in np.asarray(conn):
        row = list(e)
        for a, b in edges:
            row.append(node_at(tuple(sorted((int(e[a]), int(e[b])))),
                               (coords[e[a]] + coords[e[b]]) / 2))
        for f in faces:
            row.append(node_at(tuple(sorted(int(e[i]) for i in f)),
                               coords[list(e[list(f)])].mean(0)))
        if centre:
            row.append(node_at(tuple(sorted(map(int, e))),
                               coords[e].mean(0)))
        rows.append(row)
    return np.concatenate(new), np.asarray(rows, np.int32)


def elevate_hex(coords, conn, n27: bool):
    """A HEX8 mesh's (coords, connectivity) as HEX20, or HEX27."""
    return _elevate(coords, conn, _HEX_EDGES, _HEX_FACES if n27 else [],
                    n27)


def elevate_quad(coords, conn, n9: bool):
    """A QUAD4 mesh's (coords, connectivity) as QUAD8, or QUAD9."""
    return _elevate(coords, conn, _QUAD_EDGES, [], n9)
