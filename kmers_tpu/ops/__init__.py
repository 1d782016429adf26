"""Array compute plane: batched, jit-compiled ops over packed words.

Layer map (mirrors SURVEY.md §7 build order):

- :mod:`.u64`      — 64-bit registers as (hi, lo) uint32 pairs
- :mod:`.encode`   — ASCII classification/encoding + word packing
- :mod:`.windows`  — windowed kmer extraction, RC two-stream, canonical
- :mod:`.hashing`  — batched FxHash
- :mod:`.count`    — sort-based unique counting / table merging
- :mod:`.minimizer`— windowed minimizer selection
- :mod:`.translate_ops` — batched codon translation, six-frame AA kmers
"""

from . import u64
from .encode import classify_2bit, encode_table, pack_words, PER_WORD
from .windows import (
    window_u64,
    windows_from_codes,
    rc_windows_from_codes,
    canonical_windows_from_codes,
    rc_windows_4bit_from_codes,
    canonical_windows_4bit_from_codes,
    window_valid_mask,
)
from .hashing import fx_hash_u64, fx_hash_words
from .count import (
    SENTINEL,
    compact_counts,
    merge_compact_tables,
    merge_sorted_counts,
    sort_count,
)
from .minimizer import sliding_min_u64, minimizers
from .stats import popcount32, gc_count_u64
from .translate_ops import (
    translate_codes,
    six_frame_codes,
    aa_kmer_windows,
    six_frame_aa_kmers,
)
from .revtrans_ops import reverse_translate_codes, codon_set_table
from .multiword import (
    windows_mw,
    rc_windows_mw,
    canonical_windows_mw,
    sort_count_mw,
    fx_hash_mw,
    n_limbs,
)
