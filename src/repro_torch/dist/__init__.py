"""Distribution layer (port of ``repro/dist``): mesh plans, sharding
rules, the collective ledger and a world of ranks.

    meshes.py       MeshPlan / plan_for / Mesh: axis factorizations, and
                    one rank's process groups along them; split_fog_axes,
                    the client axes that form the fog tier
    sharding.py     ShardingRules / make_rules: logical axes -> mesh specs,
                    and the slot / batch rows of a rank
    collectives.py  CollectiveLog and its readers, in place of the JAX
                    package's HLO accounting (hlo_analysis.py): eager
                    torch has no compiled module text, so analyze_hlo and
                    HLOAnalysis have no counterpart
    world.py        World / spawn: N ranks of torch.distributed on one host
    selftest.py     the sharded LM round against the single-process round
"""
from repro_torch.dist.collectives import (
    CollectiveLog,
    CollectiveStats,
    assert_inter_client_contract,
    count_axis_crossing,
    inter_client_all_reduces,
)
from repro_torch.dist.meshes import Mesh, MeshPlan, plan_for
from repro_torch.dist.sharding import ShardingRules, make_rules

__all__ = [
    "CollectiveLog",
    "CollectiveStats",
    "Mesh",
    "MeshPlan",
    "ShardingRules",
    "assert_inter_client_contract",
    "count_axis_crossing",
    "inter_client_all_reduces",
    "make_rules",
    "plan_for",
]
