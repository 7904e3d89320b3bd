"""graph_embed: a multilevel graph partitioning + embedding framework with
the capabilities of LLNL/graph-embed, re-designed from scratch for JAX/XLA
over device meshes (see SURVEY.md for the blueprint).
"""

from .utils.profiling import enable_compilation_cache as _enable_cache

# persistent compile cache on by default (GRAPH_EMBED_NO_CACHE=1 disables):
# the multilevel pipeline compiles one program per level shape, so a cold
# run spends much of its wall time compiling
_enable_cache()

from .graph.csr import Graph, from_edges, from_coo, from_dense, submatrix
from .graph.io import (FORMATS, read_graph, read_adjlist, read_coolist,
                       read_table, read_csr, read_mtx, write_coords,
                       write_partition, write_coolist)
from .graph.laplacian import identity, to_laplacian, from_laplacian
from .graph.components import largest_component, remove_largest
from .utils.params import ForceAtlasParams, MultilevelFAParams, PartitionParams
from .forceatlas.flat import force_atlas, fa_step, compute_forces
from .partition.interpolation import Partition, compose, partition_from_labels
from .partition.modularity import modularity
from .partition.hierarchy import (HierarchyResult, partition_hierarchy,
                                  partition_single, partition_num_parts,
                                  partition_test, partition_base,
                                  partition_base2)
from .ops.spgemm import coarsen_graph

__version__ = "0.1.0"
from .forceatlas.multilevel import force_atlas_multilevel
from .embed.driver import embed, embed_graph, build_galerkin_chain
from .embed.minimization import embed_via_minimization
from .embed.via import any_to_multilevel, embed_via
from .graph.algebra import (transpose, matmul, matvec, scale_rows,
                            scale_cols)
from .graph.reorder import rcm_order, partition_order, apply_order
from .graph import synth
