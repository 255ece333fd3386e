"""Exact modular transforms (port of ``repro.core.ntt``).

Public surface:
  NTTParams / choose_modulus / root_of_unity        (parameter selection)
  ntt / intt / cyclic_polymul / negacyclic_polymul  (exact reference)
  schoolbook_polymul                                (independent O(n^2) oracle)
  RNSParams / rns_polymul / crt_to_modulus          (multi-limb RNS/CRT layer
      for 100+ bit moduli; big-int oracle in rns.schoolbook_polymul_mod)
  make_sharded_ntt / make_sharded_ntt_polymul       (distributed four-step NTT)

The kernels live in ``repro_torch.kernels.ntt``.
"""
from repro_torch.core.ntt.ref import (NTTParams, as_residues,
                                      bit_reverse_indices, choose_modulus,
                                      cyclic_polymul, intt, is_prime,
                                      negacyclic_polymul, ntt,
                                      primitive_root, root_of_unity,
                                      schoolbook_polymul)
from repro_torch.core.ntt.rns import (RNSParams, crt_reconstruct,
                                      crt_reconstruct_u64, crt_to_modulus,
                                      garner_digits, ntt_limb_primes,
                                      random_poly, rns_polymul,
                                      rns_polymul_reference,
                                      schoolbook_polymul_mod, to_rns)
from repro_torch.core.ntt.distributed import (four_step_collective_stats,
                                              make_sharded_ntt,
                                              make_sharded_ntt_polymul,
                                              ntt_distributed)

__all__ = [
    "NTTParams", "as_residues", "bit_reverse_indices", "choose_modulus",
    "cyclic_polymul", "intt", "is_prime", "negacyclic_polymul", "ntt",
    "primitive_root", "root_of_unity", "schoolbook_polymul",
    "RNSParams", "crt_reconstruct", "crt_reconstruct_u64", "crt_to_modulus",
    "garner_digits", "ntt_limb_primes", "random_poly", "rns_polymul",
    "rns_polymul_reference", "schoolbook_polymul_mod", "to_rns",
    "four_step_collective_stats", "make_sharded_ntt",
    "make_sharded_ntt_polymul", "ntt_distributed",
]
