from paimon_tpu_torch.utils.path_factory import FileStorePathFactory  # noqa: F401
