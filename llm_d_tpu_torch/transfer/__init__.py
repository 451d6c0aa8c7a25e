from llm_d_tpu_torch.transfer.connector import (  # noqa: F401
    KVConnectorConfig,
    TpuConnector,
)
from llm_d_tpu_torch.transfer.transport import (  # noqa: F401
    TransferError,
    TransferNotFound,
)
