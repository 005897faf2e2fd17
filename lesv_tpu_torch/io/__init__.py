from lesv_tpu_torch.io.fasta import read_fastx, write_fasta  # noqa: F401
from lesv_tpu_torch.io.seqstore import SeqStore, split_subreads  # noqa: F401
