from . import ipa, kzg
from .ipa import CommitterKeyIPA, IPAProof
from .kzg import CommitterKey, VerifierKeyKZG
