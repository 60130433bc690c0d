from .ethereum import EthereumTranscript
from .keccak import keccak256
