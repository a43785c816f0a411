"""BLS12-377 and Edwards-BLS12 curve parameters (the port's own copy of
``snarkos_tpu/crypto/params.py``).

These are the curves snarkOS reaches through snarkVM (SURVEY.md §2.10):
proofs/commitments live on BLS12-377 (pairing-friendly), while console
accounts/signatures live on Edwards-BLS12, the twisted Edwards curve
embedded over BLS12-377's scalar field Fr.

Every constant below was verified computationally at build time
(primality, curve membership, subgroup order, BLS-family identities
r = x^4 - x^2 + 1 and q = (x-1)^2/3 * r + x, 2-adicity, and the
quadratic-non-residuosity of the Fr generator). Do not edit by hand
without re-running ``tests/test_params.py``.
"""

# --- BLS12-377 base field Fq (377 bits) ------------------------------------
FQ_MODULUS = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
FQ_BITS = 377
FQ_TWO_ADICITY = 46

# --- BLS12-377 scalar field Fr (253 bits) ----------------------------------
FR_MODULUS = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
FR_BITS = 253
FR_TWO_ADICITY = 47
# Multiplicative generator of Fr^* (verified QNR: 22^((r-1)/2) == -1 mod r).
FR_GENERATOR = 22
# Primitive 2^47-th root of unity: 22^((r-1) >> 47) mod r.  Verified
# root^(2^46) == -1 mod r.
FR_ROOT_OF_UNITY = 0x11D4B7F60CB92CC160C69477D1A8A12F9B506EE363E3F04A476EF4A4EC2A895E

# BLS family parameter x: r = x^4 - x^2 + 1, q = ((x-1)^2 * r) / 3 + x.
BLS_X = 0x8508C00000000001
BLS_X_IS_NEGATIVE = False

# --- G1: y^2 = x^3 + 1 over Fq ---------------------------------------------
G1_COEFF_B = 1
G1_GENERATOR_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_GENERATOR_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030
G1_COFACTOR = (BLS_X - 1) ** 2 // 3  # 30631250834960419227450344600217059328

# --- Fq tower --------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 5)       (i.e. u^2 = -5; -5 is a QNR in Fq)
FQ2_NONRESIDUE = FQ_MODULUS - 5
# Fq6 = Fq2[v] / (v^3 - u)      (cubic nonresidue u)
# Fq12 = Fq6[w] / (w^2 - v)

# --- G2: y^2 = x^3 + b2 over Fq2 (D-type twist) ----------------------------
# b2 = 1 / u  (up to scaling) = (0, 0x...); derived from the generator and
# verified to match the twist equation.
G2_COEFF_B = (
    0,
    155198655607781456406391640216936120121836107652948796323930557600032281009004493664981332883744016074664192874906,
)
G2_GENERATOR_X = (
    233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
    140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
)
G2_GENERATOR_Y = (
    63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
    149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
)

# --- Edwards-BLS12 (console/account curve) ---------------------------------
# Twisted Edwards: -x^2 + y^2 = 1 + d * x^2 * y^2 over Fr(BLS12-377).
EDWARDS_A = FR_MODULUS - 1  # a = -1
EDWARDS_D = 3021
EDWARDS_GENERATOR_X = 4497879464030519973909970603271755437257548612157028181994697785683032656389
EDWARDS_GENERATOR_Y = 4357141146396347889246900916607623952598927460421559113092863576544024487809
# Prime order of the large subgroup (251 bits), cofactor 4.
EDWARDS_SUBGROUP_ORDER = 2111115437357092606062206234695386632838870926408408195193685246394721360383
EDWARDS_COFACTOR = 4

# --- Limb decomposition for the device kernels -----------------------------
# Field elements are stored as little-endian 16-bit limbs in int32 lanes,
# the JAX package's public layout; the CUDA kernels pack two limbs into
# one 32-bit word on load (see ops/modarith.py).
LIMB_BITS = 16
FQ_NLIMBS = 24  # 24 * 16 = 384 >= 377
FR_NLIMBS = 16  # 16 * 16 = 256 >= 253

# Montgomery radix per field: R = 2^(16 * nlimbs) mod p.
FQ_MONT_R = pow(2, LIMB_BITS * FQ_NLIMBS, FQ_MODULUS)
FQ_MONT_R2 = pow(2, 2 * LIMB_BITS * FQ_NLIMBS, FQ_MODULUS)
FR_MONT_R = pow(2, LIMB_BITS * FR_NLIMBS, FR_MODULUS)
FR_MONT_R2 = pow(2, 2 * LIMB_BITS * FR_NLIMBS, FR_MODULUS)

# -p^{-1} mod 2^16 for the per-limb Montgomery reduction step.
FQ_N0INV = (-pow(FQ_MODULUS, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
FR_N0INV = (-pow(FR_MODULUS, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
