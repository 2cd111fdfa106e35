"""Host I/O: FASTA/FASTQ ingestion and artifact emission."""

from .fastx import detect_format, fastx_records, fastx_pairs

__all__ = ["detect_format", "fastx_records", "fastx_pairs"]
