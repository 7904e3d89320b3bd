#!/usr/bin/env python
"""CLI-compatible replacement for the reference's scripts/plot-graph.py.

Same contract (scripts/plot-graph.py argv surface; invoked by the embedder
pipeline, examples/embedder.cpp:291-293):

    python scripts/plot-graph.py -graph mat.temp -part part.temp \
        -coords coords.temp -o plot.html

Writes a self-contained interactive HTML viewer (graph_embed.viz) with
the reference's hierarchical coarse-color + jitter scheme instead of the
legacy plotly-2 output.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from graph_embed.viz import plot_graph_html  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-graph", required=True)
    ap.add_argument("-part", required=True)
    ap.add_argument("-coords", required=True)
    ap.add_argument("-o", required=True)
    args = ap.parse_args()
    plot_graph_html(args.graph, args.part, args.coords, args.o)
    print(f"wrote {args.o}")


if __name__ == "__main__":
    main()
