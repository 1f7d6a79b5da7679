from genmmrec_tpu_torch.parallel.mesh import (
    build_mesh,
    data_sharding,
    hold_table_rows,
    model_axis_size,
    replicated,
    shard_model_params,
    sharded_topk,
    whole_tables,
)
