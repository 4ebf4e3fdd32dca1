from repro_torch.index.build import InvertedIndex, block_lists, build_inverted_index, slice_index
from repro_torch.index.compress import CODECS, compressed_size_bits, decode_postings, encode_postings
from repro_torch.index.intersect import gallop_membership

__all__ = ["CODECS", "InvertedIndex", "block_lists", "build_inverted_index", "compressed_size_bits",
           "decode_postings", "encode_postings", "gallop_membership", "slice_index"]
