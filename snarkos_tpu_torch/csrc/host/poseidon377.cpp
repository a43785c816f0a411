// Host Poseidon sponge over BLS12-377 Fr (alpha = 17, 8 full + 31 partial
// rounds, capacity 1): the node's serial hashes (every Varuna transcript,
// Schnorr challenge, account and record hash), one sponge at a time. The
// many-lane sponge of the puzzle runs on the card (ops/poseidon.py); the
// pure-Python sponge (snarkos_tpu_torch/crypto/ref/poseidon.py,
// hash_many_plain) is this engine's plain version.
//
// Parameters (ARK + MDS) are generated by the Python Grain-LFSR procedure
// and registered per rate via poseidon377_init (canonical little-endian
// 32-byte field elements); round schedule is fixed and must match
// crypto/ref/poseidon.py (FULL=8, PARTIAL=31, sbox x^17, full/2 | partial
// | full/2, each round: ark-add, sbox, MDS).

#include <cstdint>
#include <cstring>

#include "fr253.h"

static const int FULL_ROUNDS = 8;
static const int PARTIAL_ROUNDS = 31;
static const int N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS;
static const int MAX_RATE = 8;
static const int MAX_T = MAX_RATE + 1;

struct RateParams {
  bool ready;
  int t;
  Fr ark[N_ROUNDS][MAX_T];
  Fr mds[MAX_T][MAX_T];
};

static RateParams TABLES[MAX_RATE + 1];

// x^17 = ((((x^2)^2)^2)^2) * x
static inline void fr_sbox17(Fr &x) {
  Fr t;
  fr_sqr(t, x);
  fr_sqr(t, t);
  fr_sqr(t, t);
  fr_sqr(t, t);
  fr_mul(x, t, x);
}

static void permute(Fr *s, const RateParams &p) {
  const int t = p.t;
  const int half = FULL_ROUNDS / 2;
  Fr ns[MAX_T];
  for (int rnd = 0; rnd < N_ROUNDS; rnd++) {
    bool is_full = rnd < half || rnd >= half + PARTIAL_ROUNDS;
    for (int i = 0; i < t; i++) fr_add(s[i], s[i], p.ark[rnd][i]);
    if (is_full) {
      for (int i = 0; i < t; i++) fr_sbox17(s[i]);
    } else {
      fr_sbox17(s[0]);
    }
    for (int i = 0; i < t; i++) {
      Fr acc, prod;
      fr_mul(acc, p.mds[i][0], s[0]);
      for (int j = 1; j < t; j++) {
        fr_mul(prod, p.mds[i][j], s[j]);
        fr_add(acc, acc, prod);
      }
      ns[i] = acc;
    }
    std::memcpy(s, ns, t * sizeof(Fr));
  }
}

extern "C" {

// Register parameters for a rate. ark: N_ROUNDS*t canonical LE 32-byte
// elements (row-major); mds: t*t likewise. Returns 0 ok, -1 bad rate.
int poseidon377_init(int rate, const uint8_t *ark, const uint8_t *mds) {
  if (rate < 1 || rate > MAX_RATE) return -1;
  RateParams &p = TABLES[rate];
  p.t = rate + 1;
  for (int r = 0; r < N_ROUNDS; r++)
    for (int i = 0; i < p.t; i++)
      fr_load_le32(p.ark[r][i], ark + (r * p.t + i) * 32);
  for (int i = 0; i < p.t; i++)
    for (int j = 0; j < p.t; j++)
      fr_load_le32(p.mds[i][j], mds + (i * p.t + j) * 32);
  p.ready = true;
  return 0;
}

// Duplex sponge: state = [domain, 0...], absorb n inputs (add into rate
// slots, permute per full block), squeeze m outputs. Layout matches
// crypto/ref/poseidon.py hash_many_plain exactly. Returns 0 ok, -1 not inited.
int poseidon377_hash_many(int rate, const uint8_t *domain32,
                          const uint8_t *inputs, long n, uint8_t *out,
                          long m) {
  if (rate < 1 || rate > MAX_RATE || !TABLES[rate].ready) return -1;
  const RateParams &p = TABLES[rate];
  const int t = p.t;
  Fr state[MAX_T];
  std::memset(state, 0, sizeof state);
  fr_load_le32(state[0], domain32);
  int pos = 0;
  for (long k = 0; k < n; k++) {
    if (pos == rate) {
      permute(state, p);
      pos = 0;
    }
    Fr x;
    fr_load_le32(x, inputs + 32 * k);
    fr_add(state[1 + pos], state[1 + pos], x);
    pos++;
  }
  long done = 0;
  while (done < m) {
    permute(state, p);
    long take = rate < (m - done) ? rate : (m - done);
    for (long i = 0; i < take; i++) fr_store_le32(out + 32 * (done + i), state[1 + i]);
    done += take;
  }
  return 0;
}

// Raw permutation on a width-(rate+1) state (canonical LE in/out) — used by
// parity tests and any sponge variant Python wants to drive directly.
int poseidon377_permute(int rate, uint8_t *state_bytes) {
  if (rate < 1 || rate > MAX_RATE || !TABLES[rate].ready) return -1;
  const RateParams &p = TABLES[rate];
  Fr state[MAX_T];
  for (int i = 0; i < p.t; i++) fr_load_le32(state[i], state_bytes + 32 * i);
  permute(state, p);
  for (int i = 0; i < p.t; i++) fr_store_le32(state_bytes + 32 * i, state[i]);
  return 0;
}

}  // extern "C"
