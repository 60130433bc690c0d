from .merlin import MerlinTranscript, Strobe128
