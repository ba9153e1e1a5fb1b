from setk_tpu_torch.metrics.sisnr import si_snr, permute_si_snr, batch_si_snr
from setk_tpu_torch.metrics.wer import edit_distance, permute_ed
from setk_tpu_torch.metrics.bss import bss_eval_sdr, bss_eval_sources

__all__ = [
    "si_snr", "permute_si_snr", "batch_si_snr", "edit_distance", "permute_ed",
    "bss_eval_sdr", "bss_eval_sources"
]
