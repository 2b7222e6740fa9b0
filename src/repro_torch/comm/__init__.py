"""The communication codec layer over ``torch.distributed``, as in
``repro.comm``: tree codecs (``codec``), the collectives that carry them
(``exchange``), and per-call-site logical byte accounting (``metrics``)."""
# the codecs use core.transform's tree helpers, and core's optimizers use
# this package: core is initialized first, whichever package comes first
import repro_torch.core  # noqa: F401
from repro_torch.comm import metrics
from repro_torch.comm.codec import (BF16, CODECS, F32, INT8_EF, Codec,
                                    get_codec)
from repro_torch.comm.exchange import (ExchangeConfig, InFlightMean,
                                       InFlightSlices, allgather_owned_slices,
                                       allreduce_mean_leaf,
                                       allreduce_mean_tree,
                                       collect_allgather_owned_slices,
                                       collect_allreduce_mean_tree,
                                       from_extras,
                                       issue_allgather_owned_slices,
                                       issue_allreduce_mean_tree,
                                       refresh_exchange_bytes,
                                       slice_stack_specs, tree_payload_bytes)

__all__ = [
    'BF16', 'CODECS', 'F32', 'INT8_EF', 'Codec', 'get_codec',
    'ExchangeConfig', 'InFlightMean', 'InFlightSlices',
    'allgather_owned_slices', 'allreduce_mean_leaf', 'allreduce_mean_tree',
    'collect_allgather_owned_slices', 'collect_allreduce_mean_tree',
    'from_extras', 'issue_allgather_owned_slices',
    'issue_allreduce_mean_tree', 'refresh_exchange_bytes',
    'slice_stack_specs', 'tree_payload_bytes', 'metrics',
]
