"""The chemistry core: the port's own copies of coati_tpu/chem's host code
(SMILES parser, writer and permutations, canonicalizer, aromaticity, rings
and descriptors, fingerprints, conformer embedder and force field, and the
offline paths of rdkit_support). Plain Python and numpy; the modules import
each other lazily inside functions, which breaks their import cycle."""
