"""kmers_tpu: a k-mer engine for the GPU (JAX/XLA).

A from-scratch framework with the capabilities of BioJulia/Kmers.jl
(reference mounted at /root/reference; see SURVEY.md for the blueprint),
re-designed for accelerators:

- ``kmers_tpu`` (top level): the scalar API plane — symbols, alphabets,
  the :class:`Kmer` value type, construction utilities, iterators,
  translation and reverse-translation.  Bit-exact with the reference's
  semantics contracts; serves as the oracle for the array plane.
- ``kmers_tpu.ops``: the array compute plane — batched encode/pack ops,
  windowed k-mer extraction over packed uint32 words, canonicalization,
  FxHash, sort-based counting, minimizers, batched translation.
- ``kmers_tpu.parallel``: SPMD scaling — device meshes, halo-sharded
  sequence pipelines, hash-prefix all_to_all count-table merging.
- ``kmers_tpu.pipelines``: end-to-end workloads (canonical k-mer counting,
  MinHash sketching).
- ``kmers_tpu.io``: FASTA/FASTQ ingestion (native C++ parser with a
  pure-Python fallback).
"""

from .symbols import DNA, RNA, AminoAcid, NucleicAcid, EncodeError
from .alphabets import (
    Alphabet,
    NucleicAcidAlphabet,
    DNAAlphabet,
    DNAAlphabet2,
    DNAAlphabet4,
    RNAAlphabet,
    RNAAlphabet2,
    RNAAlphabet4,
    AminoAcidAlphabet,
    CharAlphabet,
    ASCII_SKIPPING_LUT,
)
from .seq import Seq, BioSequence
from .kmer import (
    Kmer,
    Mer,
    KmerType,
    DNAKmer,
    RNAKmer,
    AAKmer,
    DNACodon,
    RNACodon,
    mer,
    fx_hash,
    derive_type,
    derive_words,
    n_words,
)
from .construction import (
    RecodingScheme,
    Copyable,
    TwoToFour,
    FourToTwo,
    AsciiEncode,
    GenericRecoding,
    recoding_scheme,
    unsafe_extract,
    unsafe_shift_from,
    shift_encoding,
)
from .genetic_codes import (
    GeneticCode,
    standard_genetic_code,
    ncbi_trans_table,
    TranslationError,
)
from .revtrans import (
    CodonSet,
    ReverseGeneticCode,
    rev_standard_genetic_code,
    reverse_translate,
    reverse_translate_into,
)
from .functions import (
    translate,
    complement,
    reverse,
    reverse_complement,
    canonical,
    iscanonical,
    push,
    push_first,
    shift,
    shift_first,
    pop,
    pop_first,
    delete,
    as_integer,
    from_integer,
)
from .random import (
    rand_from_kmer,
    rand_kmer,
    rand_kmers,
    rand_kmers_mw,
    rand_kmers_device,
    rand_symbol,
)
from .iterators import (
    FwKmers,
    FwDNAMers,
    FwRNAMers,
    FwAAMers,
    FwRvIterator,
    CanonicalKmers,
    CanonicalDNAMers,
    CanonicalRNAMers,
    UnambiguousKmers,
    UnambiguousDNAMers,
    UnambiguousRNAMers,
    SpacedKmers,
    SpacedDNAMers,
    SpacedRNAMers,
    SpacedAAMers,
    each_codon,
)

__version__ = "0.1.0"
