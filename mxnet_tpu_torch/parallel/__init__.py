"""Parallelism of the port: the mesh over a torch.distributed world, the
collectives, ring attention, GPipe, the sharded embedding, the fused
TrainStep (with its mesh options), functionalize, and the training
resilience layer (ResilientLoop, the preemption watcher, the
remediation supervisor): the reference's `parallel/__init__.py`
exports."""
from .mesh import (P, PartitionSpec, build_mesh, data_parallel_mesh,
                   init_world, mesh_sharding, replica_devices, replicate,
                   shard_batch, use_mesh, world_info)
from .trainer import Shard, TrainStep
from .resilient import (ResilientLoop, PreemptionWatcher, BadStepError,
                        Preempted, EXIT_PREEMPTED, StragglerMonitor,
                        Reconfigured, EXIT_RECONFIGURE)
from .supervisor import (TrainSupervisor, CordonRoster, SDCProbe,
                         CheckpointAuditor, CordonedHostError,
                         effective_hosts)
from .ring_attention import (attention_reference, ring_attention,
                             ring_attention_sharded)
from . import collectives
from .pipeline import gpipe_apply
from .functional import functionalize, swap_param_buffers
from .embedding import row_sharded_spec, shard_embedding_params

__all__ = ["P", "PartitionSpec", "build_mesh", "data_parallel_mesh",
           "init_world", "mesh_sharding", "replica_devices", "replicate",
           "shard_batch", "use_mesh", "world_info", "Shard", "TrainStep",
           "ResilientLoop", "PreemptionWatcher", "BadStepError",
           "Preempted", "EXIT_PREEMPTED", "StragglerMonitor",
           "Reconfigured", "EXIT_RECONFIGURE", "TrainSupervisor",
           "CordonRoster", "SDCProbe", "CheckpointAuditor",
           "CordonedHostError", "effective_hosts",
           "attention_reference", "ring_attention", "ring_attention_sharded",
           "collectives", "gpipe_apply", "functionalize",
           "swap_param_buffers", "row_sharded_spec",
           "shard_embedding_params"]
