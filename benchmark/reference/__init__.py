"""The plain reference that decides ``correct``: a KZG PLONK verifier on
plain ints (``plonk_kzg``) over frozen copies of the circuit's host code
(``frozen/``).  Nothing here imports the system under test."""
