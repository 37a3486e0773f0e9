"""Frame-parallel serving over processes, one per device
(``torch.distributed``): the mesh (``mesh``), the sharded pipelines
(``sharding``), and a dry run over N spawned ranks (``python -m
cylinder_pose_estimation_tpu_torch.parallel.dryrun``)."""

from cylinder_pose_estimation_tpu_torch.parallel import mesh, sharding
