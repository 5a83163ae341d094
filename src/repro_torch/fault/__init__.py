from .failures import (ElasticPolicy, FailureInjector, ShardFailure,
                       SimulatedFailure, elastic_queue_policy,
                       run_with_restarts)

__all__ = ["ElasticPolicy", "FailureInjector", "ShardFailure",
           "SimulatedFailure", "elastic_queue_policy", "run_with_restarts"]
