"""Self-organizing maps of the port (counterpart of the JAX package's
``som``): the potential-field initial nodes and the batched fit."""

from .potential_field import potential_field_nodes
from .som import (SOMConfig, batch_update, fit, init_nodes, query,
                  query_topk)

__all__ = ["SOMConfig", "init_nodes", "batch_update", "fit", "query",
           "query_topk", "potential_field_nodes"]
