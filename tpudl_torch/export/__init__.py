"""Export, parity and latency: the port's counterpart of tpudl.export.

The reference's signature behaviour (SURVEY.md §0): serialize a model,
run the artifact on two backends, compare the outputs numerically and
report latency. tpudl serializes StableHLO and runs it on CPU-XLA and
TPU-XLA; the port serializes ``torch.export`` programs (``.pt2``) whose
kernels are ``tpudl::`` ops (tpudl_torch.ops.library), so one artifact
runs on the card (the Hopper kernels) and on the CPU (their plain
versions). Parameters are inputs of the artifact, as in tpudl's, and are
saved apart in the safetensors format (tpudl: Orbax).
"""

from tpudl_torch.export.export import (  # noqa: F401
    artifact_sizes,
    export_program,
    forward_fn,
    load_exported,
    load_exported_obj,
    load_params,
    save_params,
)
from tpudl_torch.export.latency import LatencyStats, latency_benchmark  # noqa: F401
from tpudl_torch.export.parity import (  # noqa: F401
    ParityReport,
    assert_parity,
    check_parity,
    compare_outputs,
)
