"""Graph substrate: weighted graphs/trees, MST, traversals, mesh generators."""
from repro_torch.graphs.graph import Forest, Graph, WeightedTree  # noqa: F401
from repro_torch.graphs.mst import (  # noqa: F401
    minimum_spanning_forest,
    minimum_spanning_tree,
)
from repro_torch.graphs.traverse import TreeLCA, tree_all_pairs  # noqa: F401
