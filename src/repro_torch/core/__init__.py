"""Graph IR of the port (the part the CNN builders and executor use)."""

from .graph import (FREE_KINDS, IMC_KINDS, Graph, GraphError, Node, OpKind,
                    PUType, default_pu_type)

__all__ = ["FREE_KINDS", "IMC_KINDS", "Graph", "GraphError", "Node", "OpKind",
           "PUType", "default_pu_type"]
