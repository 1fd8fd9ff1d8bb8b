"""The port's graph IR and ResNet deployment graphs against the JAX
package's: identical JSON, node counts and Table I ids."""

import pytest

pytest.importorskip("torch")

from repro.models.cnn import graphs as jgraphs
from repro_torch.core.graph import Graph, GraphError, OpKind, PUType
from repro_torch.models.cnn import graphs, layers

BUILDERS = {"resnet8": (graphs.resnet8_graph, jgraphs.resnet8_graph),
            "resnet18": (graphs.resnet18_graph, jgraphs.resnet18_graph)}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_to_json_equals_reference(name):
    port, ref = BUILDERS[name]
    assert port().to_json() == ref().to_json()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_json_round_trip(name):
    g = BUILDERS[name][0]()
    g2 = Graph.from_json(g.to_json())
    assert g2.to_json() == g.to_json()
    assert g2.topo_order() == g.topo_order()


def test_resnet8_counts():
    g = graphs.resnet8_graph()
    assert len(g) == 14 == len(jgraphs.resnet8_graph())
    assert g.num_nodes(pu_type=PUType.IMC) == 10


def test_resnet18_counts_and_table1_ids():
    g = graphs.resnet18_graph()
    assert len(g) == 30
    assert g.num_nodes(kind=OpKind.CONV) == 20
    assert g.num_nodes(kind=OpKind.MVM) == 1
    imc = {nid for nid, nd in g.nodes.items() if nd.pu_type == PUType.IMC}
    assert imc == set(graphs.TABLE1_IMC_NODE_IDS)
    assert graphs.TABLE1_IMC_NODE_IDS == jgraphs.TABLE1_IMC_NODE_IDS
    assert g.sources() == [1] and g.sinks() == [30]
    assert g.total_weight_bytes() == jgraphs.resnet18_graph().total_weight_bytes()


def test_graph_errors():
    g = Graph("t")
    a = g.add("a", OpKind.CONV)
    b = g.add("b", OpKind.ADD, deps=[a.node_id])
    with pytest.raises(GraphError):
        g.add_edge(a.node_id, 99)
    g.add_edge(b.node_id, a.node_id)
    with pytest.raises(GraphError):
        g.validate()


@pytest.mark.parametrize("h,k,stride,padding,want", [
    (32, 3, 1, "SAME", (1, 1, 1, 1)),
    (32, 3, 2, "SAME", (0, 1, 0, 1)),     # not symmetric: XLA's floor/ceil
    (32, 1, 2, "SAME", (0, 0, 0, 0)),
    (9, 3, 2, "SAME", (1, 1, 1, 1)),
    (12, 5, 1, "SAME", (2, 2, 2, 2)),
    (9, 3, 2, "VALID", (0, 0, 0, 0)),
])
def test_conv_pads(h, k, stride, padding, want):
    assert layers.conv_pads(h, h, k, stride, padding) == want
