from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process
from mraudio_tpu_torch.text.tokenizer import ByteTokenizer

__all__ = ["post_process", "moment_str_to_list", "ByteTokenizer"]
