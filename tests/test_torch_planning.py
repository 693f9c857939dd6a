"""Port parity: the planning layer (controller, layer tables, analytic model).

``repro_torch.core.{modes,networks,cost_model}`` are copies of the JAX
package's pure-Python modules; every layer of every table must get the same
dataflow and the same ``LayerCost`` from both, and the network totals must
agree exactly.
"""
import dataclasses

import pytest

from repro.core import cost_model as j_cost
from repro.core import modes as j_modes
from repro.core import networks as j_nets
from repro.models import cnn as j_cnn
from repro_torch.core import cost_model as t_cost
from repro_torch.core import modes as t_modes
from repro_torch.core import networks as t_nets
from repro_torch.models import cnn as t_cnn

TABLES = {
    "resnet50": lambda n: n.resnet50_conv_layers(),
    "resnet50_sparse": lambda n: n.resnet50_conv_layers(sparse=True),
    "projections": lambda n: n.resnet50_projection_shortcuts(),
    "vgg16": lambda n: n.vgg16_conv_layers(),
    "smoke": lambda n: n.smoke_conv_layers(),
    "smoke_sparse": lambda n: n.smoke_conv_layers(sparse=True),
}
COST_FIELDS = ("cycles", "dram_in", "dram_weights", "dram_out", "macs",
               "dram_total", "dram_bytes", "time_s", "puf")


@pytest.mark.parametrize("table", list(TABLES))
def test_every_layer_same_dataflow_and_cost(table):
    j_layers, t_layers = TABLES[table](j_nets), TABLES[table](t_nets)
    assert len(j_layers) == len(t_layers) > 0
    for jl, tl in zip(j_layers, t_layers):
        assert dataclasses.astuple(jl) == dataclasses.astuple(tl)
        assert (jl.OL, jl.macs, jl.dense_macs) == (tl.OL, tl.macs,
                                                   tl.dense_macs)
        assert (j_modes.select_dataflow(jl).value
                == t_modes.select_dataflow(tl).value)
        jc, tc = j_cost.layer_cost(jl), t_cost.layer_cost(tl)
        assert jc.dataflow.value == tc.dataflow.value
        for f in COST_FIELDS:
            assert getattr(jc, f) == getattr(tc, f), (tl.name, f)
        assert j_cost.puf_closed_form(jl) == t_cost.puf_closed_form(tl)
        assert j_cost.eq10_as_printed(jl) == t_cost.eq10_as_printed(tl)


@pytest.mark.parametrize("net", ["resnet50", "resnet50_sparse", "vgg16"])
def test_network_totals_equal(net):
    def cost(m):
        if net == "vgg16":
            return m.vgg16_cost()
        return m.resnet50_cost(sparse=net.endswith("sparse"))
    jn, tn = cost(j_cost), cost(t_cost)
    assert jn.name == tn.name
    for f in ("cycles", "time_ms", "dram_mb", "macs", "gops", "puf"):
        assert getattr(jn, f) == getattr(tn, f), f


def test_paper_headlines_from_the_port():
    """The analytic ASIC model's figures against the paper's 92.7 / 42.5 /
    396.9 ms, within the relative bands of ``benchmarks/run.py``."""
    for got, paper, band in ((t_cost.resnet50_cost().time_ms, 92.7, 0.005),
                             (t_cost.resnet50_cost(sparse=True).time_ms,
                              42.5, 0.005),
                             (t_cost.vgg16_cost().time_ms, 396.9, 0.011)):
        assert abs(got - paper) / paper <= band, (got, paper)


def test_stationarity_rule_matches():
    for rows in range(0, 400):
        assert (j_modes.select_stationarity(rows).value
                == t_modes.select_stationarity(rows).value)


@pytest.mark.parametrize("table", ["smoke", "resnet50"])
def test_sparse_conv_layers_and_epilogue_delta_match(table):
    for jl, tl in zip(j_nets.sparse_conv_layers(table),
                      t_nets.sparse_conv_layers(table)):
        assert dataclasses.astuple(jl) == dataclasses.astuple(tl)
        for ops in ({}, {"scale_bias": True}, {"relu": True, "residual": True},
                    {"scale_bias": True, "relu": True, "residual": True}):
            assert (j_cost.epilogue_dram_delta_bytes(jl, **ops)
                    == t_cost.epilogue_dram_delta_bytes(tl, **ops))


@pytest.mark.parametrize("table", ["resnet50", "vgg16"])
def test_network_plan_matches(table):
    layers = TABLES[table](t_nets)
    for jp, tp in zip(j_cnn.network_plan(TABLES[table](j_nets)),
                      t_cnn.network_plan(layers)):
        assert dataclasses.astuple(jp.layer) == dataclasses.astuple(tp.layer)
        assert jp.dataflow.value == tp.dataflow.value
        assert jp.cost.cycles == tp.cost.cycles
        assert jp.cost.dram_bytes == tp.cost.dram_bytes
