from .maxsim import (NEG_INF, build_kernels, coarse_sweep, coarse_sweep_int8,
                     coarse_sweep_int8_torch, coarse_sweep_torch,
                     flipr_reduce, maxsim_all_pairs_blocked,
                     maxsim_all_pairs_xla, maxsim_pair_xla, maxsim_reduce,
                     maxsim_search, maxsim_search_torch, stage1_rows,
                     stage1_sweep, stage1_sweep_torch)
from .losses import dpr_in_batch_loss, in_batch_negative_loss, nway_ce_loss
from .quant import (dequantize_int8, maxsim_search_int8,
                    maxsim_search_int8_q8_torch, maxsim_search_int8_torch,
                    quantize_index_int8, quantize_queries_int8,
                    quantize_summaries_int8, quantize_summaries_t_int8)
from .residual import (ResidualCodec, compress, decompress, maxsim_residual,
                       maxsim_residual_torch, pack_records, record_bytes,
                       split_records, train_codec, train_codec_factored,
                       unpack_bits)

__all__ = ["NEG_INF", "build_kernels", "coarse_sweep", "coarse_sweep_int8",
           "coarse_sweep_int8_torch", "coarse_sweep_torch", "flipr_reduce",
           "maxsim_all_pairs_blocked", "maxsim_all_pairs_xla",
           "maxsim_pair_xla", "dpr_in_batch_loss", "in_batch_negative_loss",
           "nway_ce_loss", "maxsim_reduce",
           "maxsim_search", "maxsim_search_torch", "stage1_rows",
           "stage1_sweep", "stage1_sweep_torch", "dequantize_int8",
           "maxsim_search_int8", "maxsim_search_int8_q8_torch",
           "maxsim_search_int8_torch", "quantize_index_int8",
           "quantize_queries_int8", "quantize_summaries_int8",
           "quantize_summaries_t_int8", "ResidualCodec", "compress",
           "decompress", "maxsim_residual", "maxsim_residual_torch",
           "pack_records", "record_bytes", "split_records", "train_codec",
           "train_codec_factored", "unpack_bits"]
