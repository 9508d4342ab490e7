from alga_tpu_torch.core.seqbatch import SeqBatch  # noqa: F401
from alga_tpu_torch.core import packing  # noqa: F401
