"""Biological symbol types: DNA, RNA, AminoAcid.

Array-plane-ready re-implementation of the symbol substrate the reference package
(BioJulia/Kmers.jl) gets from BioSymbols.jl (see SURVEY.md §2.6).  The bit
encodings are contractual and must match BioSymbols exactly:

- Nucleotides carry a 4-bit code where each bit is a "compat" flag:
  A=0b0001, C=0b0010, G=0b0100, T/U=0b1000; ambiguity codes are unions
  (e.g. M = A|C = 0b0011), gap = 0b0000, N = 0b1111.
- Amino acids carry an 8-bit code 0x00..0x1b in BioSymbols order:
  A R N D C Q E G H I L K M F P S T W Y V O U B J Z X * -
  (reference parity anchor: ``as_integer(mer"KWPQHVY"a) == 0x000b110e05081312``,
  /root/reference/src/kmer.jl:294).

Symbols are interned singletons: ``DNA.A is DNA.from_char('a')``.
"""

from __future__ import annotations

__all__ = ["DNA", "RNA", "AminoAcid", "EncodeError"]


class EncodeError(ValueError):
    """Raised when a symbol/byte cannot be encoded in a given alphabet.

    Mirrors ``BioSequences.EncodeError`` (used at
    /root/reference/src/construction_utils.jl:79-87).
    """

    def __init__(self, alphabet, value):
        self.alphabet = alphabet
        self.value = value
        shown = (
            f"0x{value:02x} (char {chr(value)!r})"
            if isinstance(value, int) and 0 <= value < 256
            else repr(value)
        )
        super().__init__(f"cannot encode {shown} in {alphabet}")


class _Symbol:
    """Base for interned, immutable biological symbols."""

    __slots__ = ("code", "char")
    _instances: tuple = ()
    _by_char: dict = {}

    def __init__(self, code: int, char: str):
        object.__setattr__(self, "code", code)
        object.__setattr__(self, "char", char)

    def __setattr__(self, *_):
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __reduce__(self):
        # interned singletons: reconstruct through the registry
        return (type(self).from_code, (self.code,))

    def __repr__(self):
        return f"{type(self).__name__}_{self.char if self.char not in '*-' else ('Term' if self.char == '*' else 'Gap')}"

    def __str__(self):
        return self.char

    def __hash__(self):
        return hash((type(self).__name__, self.code))

    def __eq__(self, other):
        if isinstance(other, _Symbol):
            return type(self) is type(other) and self.code == other.code
        return NotImplemented

    def __lt__(self, other):
        if type(self) is type(other):
            return self.code < other.code
        return NotImplemented

    @classmethod
    def from_code(cls, code: int):
        return cls._instances[code]

    @classmethod
    def from_char(cls, c: str):
        try:
            return cls._by_char[c]
        except KeyError:
            raise EncodeError(cls.__name__, c) from None

    @classmethod
    def coerce(cls, x):
        """Convert a char / symbol of a compatible type to this symbol type."""
        if isinstance(x, cls):
            return x
        if isinstance(x, str) and len(x) == 1:
            return cls.from_char(x)
        if isinstance(x, _Symbol):
            return cls._coerce_symbol(x)
        raise EncodeError(cls.__name__, x)

    @classmethod
    def _coerce_symbol(cls, x):
        raise EncodeError(cls.__name__, x)


class _Nucleotide(_Symbol):
    """Shared behavior for DNA and RNA (4-bit compat-bit codes)."""

    __slots__ = ()

    @property
    def compatbits(self) -> int:
        return self.code

    @property
    def isgap(self) -> bool:
        return self.code == 0

    @property
    def iscertain(self) -> bool:
        return bin(self.code).count("1") == 1

    @property
    def isambiguous(self) -> bool:
        # BioSymbols: ambiguous iff more than one compat bit (gap is NOT ambiguous)
        return bin(self.code).count("1") > 1

    @property
    def isGC(self) -> bool:
        # BioSymbols.isGC: true for G, C, S (= G|C)
        return self.code != 0 and (self.code & ~0b0110) == 0

    def complement(self):
        # 4-bit complement = bit-reversal of the nibble (A<->T/U, C<->G,
        # unions complement element-wise).  /root/reference/src/transformations.jl:12-25
        c = self.code
        rev = ((c & 1) << 3) | ((c & 2) << 1) | ((c & 4) >> 1) | ((c & 8) >> 3)
        return type(self).from_code(rev)

    @classmethod
    def _coerce_symbol(cls, x):
        if isinstance(x, _Nucleotide):
            return cls.from_code(x.code)
        raise EncodeError(cls.__name__, x)


class DNA(_Nucleotide):
    __slots__ = ()


class RNA(_Nucleotide):
    __slots__ = ()


# Nucleotide chars ordered by 4-bit code (BioSymbols order).
_DNA_CHARS = "-ACMGRSVTWYHKDBN"
_RNA_CHARS = "-ACMGRSVUWYHKDBN"

for _cls, _chars in ((DNA, _DNA_CHARS), (RNA, _RNA_CHARS)):
    _insts = tuple(_cls(i, ch) for i, ch in enumerate(_chars))
    _cls._instances = _insts
    _cls._by_char = {}
    for _s in _insts:
        _cls._by_char[_s.char] = _s
        _cls._by_char[_s.char.lower()] = _s
    for _s in _insts:
        _name = _s.char if _s.char not in "-" else "Gap"
        setattr(_cls, _name, _s)


#: Public name for the nucleotide symbol base (the reference re-exports
#: BioSymbols' ``NucleicAcid``): ``isinstance(x, NucleicAcid)`` matches
#: both DNA and RNA symbols.
NucleicAcid = _Nucleotide


class AminoAcid(_Symbol):
    __slots__ = ()

    @property
    def isgap(self) -> bool:
        return self.code == 0x1B

    @property
    def isterm(self) -> bool:
        return self.code == 0x1A

    @property
    def isambiguous(self) -> bool:
        # B, J, Z, X are ambiguous (codes 0x16..0x19)
        return 0x16 <= self.code <= 0x19

    @property
    def iscertain(self) -> bool:
        return self.code < 0x16 or self.code == 0x1A

    @property
    def compatbits(self) -> int:
        """Bitmask over the 26 concrete AA codes this symbol is compatible with.

        Mirrors BioSymbols.compatbits: B ~ {D,N}, J ~ {I,L}, Z ~ {E,Q},
        X ~ all 22 non-ambiguous non-term non-gap AAs.
        """
        c = self.code
        if c < 0x16:  # concrete incl. O, U
            return 1 << c
        if c == 0x16:  # B = D | N
            return (1 << 0x03) | (1 << 0x02)
        if c == 0x17:  # J = I | L
            return (1 << 0x09) | (1 << 0x0A)
        if c == 0x18:  # Z = E | Q
            return (1 << 0x06) | (1 << 0x05)
        if c == 0x19:  # X = all 22 certain AAs
            return (1 << 0x16) - 1
        return 0  # Term, Gap

    @classmethod
    def _coerce_symbol(cls, x):
        raise EncodeError(cls.__name__, x)


_AA_CHARS = "ARNDCQEGHILKMFPSTWYVOUBJZX*-"
_aa_insts = tuple(AminoAcid(i, ch) for i, ch in enumerate(_AA_CHARS))
AminoAcid._instances = _aa_insts
AminoAcid._by_char = {}
for _s in _aa_insts:
    AminoAcid._by_char[_s.char] = _s
    if _s.char.isalpha():
        AminoAcid._by_char[_s.char.lower()] = _s
for _s in _aa_insts:
    _name = _s.char if _s.char.isalpha() else ("Term" if _s.char == "*" else "Gap")
    setattr(AminoAcid, _name, _s)
