"""Distribution of the port: logical-axis sharding rules on DTensor, the
mesh context, and the GPipe schedule."""

from .sharding import (Rules, default_rules, logical_constraint,
                       tree_shardings, use_mesh)

__all__ = ["Rules", "default_rules", "logical_constraint", "tree_shardings",
           "use_mesh"]
