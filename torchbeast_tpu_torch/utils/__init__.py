from torchbeast_tpu_torch.utils.file_writer import FileWriter  # noqa: F401
