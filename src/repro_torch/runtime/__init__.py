from .elastic import ElasticPlan, largest_pow2_leq, plan_remesh
from .fault_tolerance import StragglerDetector, TrainSupervisor

__all__ = ["ElasticPlan", "StragglerDetector", "TrainSupervisor",
           "largest_pow2_leq", "plan_remesh"]
