from repro_torch.sharding.rules import (FlatShardings, MeshShape, NamedSharding, P,
                                        PartitionSpec, axis_size, batch_specs, cache_specs,
                                        data_axes, flat_axes, flat_bank_spec, flat_shardings,
                                        flat_theta_spec, mesh_shape, named, paged_shardings,
                                        param_specs, spec_for_param)
