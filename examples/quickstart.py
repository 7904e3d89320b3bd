"""Quickstart: partition + embed + plot a small community graph.

  python examples/quickstart.py [out.html]

Produces an interactive HTML layout colored by the partition hierarchy and
prints a JSON quality record.
"""

import json
import sys

import numpy as np


def main():
    import jax

    import graph_embed as gt
    from graph_embed.harness.runtests import layout_stress
    from graph_embed.viz import write_embedding_html

    out = sys.argv[1] if len(sys.argv) > 1 else "quickstart.html"
    rng = np.random.default_rng(0)

    # planted communities: 6 blobs of 40 + sparse inter edges
    n, k = 240, 6
    size = n // k
    s_list, r_list = [], []
    for c in range(k):
        off = c * size
        for i in range(size):
            for j in range(i + 1, size):
                if rng.random() < 0.3:
                    s_list.append(off + i)
                    r_list.append(off + j)
    for _ in range(80):
        a, b = rng.integers(0, n, 2)
        if a != b:
            s_list.append(int(a))
            r_list.append(int(b))
    g = gt.from_edges(s_list, r_list, None, n=n, symmetrize=True)

    coords, hierarchy = gt.embed_graph(
        g, dim=3, coarsening_factor=0.15, base_iterations=1000,
        refine_iterations=100, key=jax.random.PRNGKey(0))

    s, r, _ = g.to_coo_numpy()
    write_embedding_html(
        np.asarray(coords), (s, r), out,
        level_assignments=[np.asarray(p.vertex_to_agg)
                           for p in hierarchy.levels])
    print(json.dumps({
        "n": g.n, "edges": g.num_edges,
        "levels": hierarchy.level_sizes,
        "modularity_l1": float(gt.modularity(g, hierarchy.levels[0])),
        "stress": layout_stress(g, coords),
        "html": out,
    }))


if __name__ == "__main__":
    main()
