from .ethereum import EthereumTranscript
from .merlin import MerlinTranscript, Strobe128
from .keccak import keccak256
