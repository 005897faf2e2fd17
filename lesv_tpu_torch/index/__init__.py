from lesv_tpu_torch.index.kmer_index import KmerIndex  # noqa: F401
