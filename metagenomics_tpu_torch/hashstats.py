"""Reference hash-table statistics (insertDataset log parity).

The reference builds an open-addressing table of string buckets before
graph construction and logs its vital signs: the prime table size, total
probe collisions, and the longest bucket with its first entry
(HashTable.cpp:50-80).  The TPU pipeline never builds that table — the
l-mer index is a sorted-key join — but the log stream is part of the
parity surface, so this module SIMULATES the reference insertion exactly:
same 450-entry prime size table (data constants from HashTable.cpp:23),
same two-accumulator hash (:135-155, with uint64 wrap-around), same
linear-probe collision counting against each bucket's first entry
(:163-195), same (read asc, orient 0..3) insertion order.

The native engine does the scan (mg_hashstats); a Python fallback covers
no-compiler environments.
"""

import numpy as np

# Pre-computed hash table sizes: the reference picks the first entry larger
# than 8 * unique_reads + 1 (HashTable.cpp:20-29, :56).  Data constants.
PRIMES = [
    1114523, 1180043, 1245227, 1310759, 1376447, 1442087, 1507379, 1573667,
    1638899, 1704023, 1769627, 1835027, 1900667, 1966127, 2031839, 2228483,
    2359559, 2490707, 2621447, 2752679, 2883767, 3015527, 3145739, 3277283,
    3408323, 3539267, 3670259, 3801143, 3932483, 4063559, 4456643, 4718699,
    4980827, 5243003, 5505239, 5767187, 6029603, 6291563, 6553979, 6816527,
    7079159, 7340639, 7602359, 7864799, 8126747, 8913119, 9437399, 9962207,
    10485767, 11010383, 11534819, 12059123, 12583007, 13107923, 13631819,
    14156543, 14680067, 15204467, 15729647, 16253423, 17825999, 18874379,
    19923227, 20971799, 22020227, 23069447, 24117683, 25166423, 26214743,
    27264047, 28312007, 29360147, 30410483, 31457627, 32505983, 35651783,
    37749983, 39845987, 41943347, 44040383, 46137887, 48234623, 50331707,
    52429067, 54526019, 56623367, 58720307, 60817763, 62915459, 65012279,
    71303567, 75497999, 79691867, 83886983, 88080527, 92275307, 96470447,
    100663439, 104858387, 109052183, 113246699, 117440699, 121635467,
    125829239, 130023683, 142606379, 150994979, 159383759, 167772239,
    176160779, 184549559, 192938003, 201327359, 209715719, 218104427,
    226493747, 234882239, 243269639, 251659139, 260047367, 285215507,
    301989959, 318767927, 335544323, 352321643, 369100463, 385876703,
    402654059, 419432243, 436208447, 452986103, 469762067, 486539519,
    503316623, 520094747, 570425399, 603979919, 637534763, 671089283,
    704643287, 738198347, 771752363, 805307963, 838861103, 872415239,
    905971007, 939525143, 973079279, 1006633283, 1040187419, 1140852767,
    1207960679, 1275069143, 1342177379, 1409288183, 1476395699, 1543504343,
    1610613119, 1677721667, 1744830587, 1811940419, 1879049087, 1946157419,
    2013265967, 2080375127, 2281701827, 2415920939, 2550137039, 2684355383,
    2818572539, 2952791147, 3087008663, 3221226167, 3355444187, 3489661079,
    3623878823, 3758096939, 3892314659, 4026532187, 4160749883, 4563403379,
    4831838783, 5100273923, 5368709219, 5637144743, 5905580687, 6174015503,
    6442452119, 6710886467, 6979322123, 7247758307, 7516193123, 7784629079,
    8053065599, 8321499203, 9126806147, 9663676523, 10200548819, 10737418883,
    11274289319, 11811160139, 12348031523, 12884902223, 13421772839,
    13958645543, 14495515943, 15032386163, 15569257247, 16106127887,
    16642998803, 18253612127, 19327353083, 20401094843, 21474837719,
    22548578579, 23622320927, 24696062387, 25769803799, 26843546243,
    27917287907, 28991030759, 30064772327, 31138513067, 32212254947,
    33285996803, 36507222923, 38654706323, 40802189423, 42949673423,
    45097157927, 47244640319, 49392124247, 51539607599, 53687092307,
    55834576979, 57982058579, 60129542339, 62277026327, 64424509847,
    66571993199, 73014444299, 77309412407, 81604379243, 85899346727,
    90194314103, 94489281203, 98784255863, 103079215439, 107374183703,
    111669150239, 115964117999, 120259085183, 124554051983, 128849019059,
    133143986399, 146028888179, 154618823603, 163208757527, 171798693719,
    180388628579, 188978561207, 197568495647, 206158430447, 214748365067,
    223338303719, 231928234787, 240518168603, 249108103547, 257698038539,
    266287975727, 292057776239, 309237645803, 326417515547, 343597385507,
    360777253763, 377957124803, 395136991499, 412316861267, 429496730879,
    446676599987, 463856468987, 481036337207, 498216206387, 515396078039,
    532575944723, 584115552323, 618475290887, 652835029643, 687194768879,
    721554506879, 755914244627, 790273985219, 824633721383, 858993459587,
    893353198763, 927712936643, 962072674643, 996432414899, 1030792152539,
    1065151889507, 1168231105859, 1236950582039, 1305670059983,
    1374389535587, 1443109012607, 1511828491883, 1580547965639,
    1649267441747, 1717986918839, 1786706397767, 1855425872459,
    1924145348627, 1992864827099, 2061584304323, 2130303780503,
    2336462210183, 2473901164367, 2611340118887, 2748779070239,
    2886218024939, 3023656976507, 3161095931639, 3298534883999,
    3435973836983, 3573412791647, 3710851743923, 3848290698467,
    3985729653707, 4123168604483, 4260607557707, 4672924419707,
    4947802331663, 5222680234139, 5497558138979, 5772436047947,
    6047313952943, 6322191860339, 6597069767699, 6871947674003,
    7146825580703, 7421703488567, 7696581395627, 7971459304163,
    8246337210659, 8521215117407, 9345848837267, 9895604651243,
    10445360463947, 10995116279639, 11544872100683, 12094627906847,
    12644383722779, 13194139536659, 13743895350023, 14293651161443,
    14843406975659, 15393162789503, 15942918604343, 16492674420863,
    17042430234443, 18691697672867, 19791209300867, 20890720927823,
    21990232555703, 23089744183799, 24189255814847, 25288767440099,
    26388279068903, 27487790694887, 28587302323787, 29686813951463,
    30786325577867, 31885837205567, 32985348833687, 34084860462083,
    37383395344739, 39582418600883, 41781441856823, 43980465111383,
    46179488367203, 48378511622303, 50577534878987, 52776558134423,
    54975581392583, 57174604644503, 59373627900407, 61572651156383,
    63771674412287, 65970697666967, 68169720924167, 74766790688867,
    79164837200927, 83562883712027, 87960930223163, 92358976733483,
    96757023247427, 101155069756823, 105553116266999, 109951162779203,
    114349209290003, 118747255800179, 123145302311783, 127543348823027,
    131941395333479, 136339441846019, 149533581378263, 158329674402959,
    167125767424739, 175921860444599, 184717953466703, 193514046490343,
    202310139514283, 211106232536699, 219902325558107, 228698418578879,
    237494511600287, 246290604623279, 255086697645023, 263882790666959,
    272678883689987, 299067162755363, 316659348799919, 334251534845303,
    351843720890723, 369435906934019, 387028092977819, 404620279022447,
    422212465067447, 439804651111103, 457396837157483, 474989023199423,
    492581209246163, 510173395291199, 527765581341227, 545357767379483,
    598134325510343, 633318697599023, 668503069688723, 703687441776707,
    738871813866287, 774056185954967, 809240558043419, 844424930134187,
    879609302222207, 914793674313899, 949978046398607, 985162418489267,
    1020346790579903, 1055531162666507, 1090715534754863
]


def table_size(unique_reads: int) -> int:
    """getPrimeLargerThanNumber(8u + 1) (HashTable.cpp:20-29, :56)."""
    need = unique_reads * 8 + 1
    for p in PRIMES:
        if p > need:
            return p
    return need + 1


# rank code (A0 C1 G2 T3) -> reference hash bit code ((ascii >> 1) & 3)
_BC = np.array([0, 1, 3, 2], dtype=np.uint64)


def _hash_indices(ds, l, p):
    """Vectorized two-accumulator hash of the 4 keys per read, in
    (read, orient 0..3) interleaved order (HashTable.cpp:88-104)."""
    u = ds.number_of_unique_reads
    rows = np.arange(1, u + 1)
    suf = ds.lengths[1:u + 1] - l
    keys = np.empty((4 * u, l), dtype=np.uint8)
    keys[0::4] = ds.codes_fwd[1:u + 1, :l]
    keys[2::4] = ds.codes_rev[1:u + 1, :l]
    cols = suf[:, None] + np.arange(l)[None, :]
    keys[1::4] = np.take_along_axis(ds.codes_fwd[1:u + 1], cols, axis=1)
    keys[3::4] = np.take_along_axis(ds.codes_rev[1:u + 1], cols, axis=1)
    bc = _BC[keys]
    sum1 = np.full(4 * u, 1, dtype=np.uint64)
    for k in range(min(32, l)):
        sum1 = (sum1 << np.uint64(2)) | bc[:, k]
    sum2 = np.full(4 * u, 1, dtype=np.uint64)
    for k in range(32, l):
        sum2 = (sum2 << np.uint64(2)) | bc[:, k]
    pp = np.uint64(p)
    idx = ((sum1 % pp) * (sum2 % pp)) % pp
    return idx.astype(np.int64), keys


def simulate(ds, min_overlap):
    """Returns (table_size, collisions, longest, first_rid, first_orient,
    checkpoints): the counters the reference's insertDataset logs."""
    l = min_overlap - 1
    u = ds.number_of_unique_reads
    p = table_size(u)
    native = _simulate_native(ds, l, p)
    if native is not None:
        return native
    idx_arr, keys = _hash_indices(ds, l, p)
    rep = {}          # bucket index -> (key bytes, rid, orient, size)
    collisions = 0
    checkpoints = []
    for e in range(4 * u):
        idx = int(idx_arr[e])
        kb = keys[e].tobytes()
        while idx in rep:
            if rep[idx][0] == kb:
                break
            collisions += 1
            idx = 0 if idx == p - 1 else idx + 1
        if idx in rep:
            r = rep[idx]
            rep[idx] = (r[0], r[1], r[2], r[3] + 1)
        else:
            rep[idx] = (kb, e // 4 + 1, e % 4, 1)
        if e % 4 == 3 and (e // 4 + 1) % 1000000 == 0:
            checkpoints.append(collisions)
    longest = 0
    first_rid = first_orient = 0
    for idx in sorted(rep):
        r = rep[idx]
        if r[3] > longest:
            longest = r[3]
            first_rid = r[1]
            first_orient = r[2]
    return p, collisions, longest, first_rid, first_orient, checkpoints


def _simulate_native(ds, l, p):
    from . import native
    import ctypes
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "mg_hashstats"):
        return None
    u = ds.number_of_unique_reads
    out = np.zeros(4, dtype=np.int64)
    ncp = u // 1000000
    cps = np.zeros(max(ncp, 1), dtype=np.int64)
    lengths = np.ascontiguousarray(ds.lengths, dtype=np.int64)
    cf = np.ascontiguousarray(ds.codes_fwd)
    cr = np.ascontiguousarray(ds.codes_rev)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mg_hashstats(
        ctypes.c_int64(u), lengths.ctypes.data_as(i64p),
        cf.ctypes.data_as(u8p), cr.ctypes.data_as(u8p),
        ctypes.c_int64(cf.shape[1]), ctypes.c_int64(l), ctypes.c_int64(p),
        out.ctypes.data_as(i64p), cps.ctypes.data_as(i64p),
        ctypes.c_int64(ncp))
    return (p, int(out[0]), int(out[1]), int(out[2]), int(out[3]),
            cps[:ncp].tolist())


def emit_insert_dataset_log(ds, min_overlap, log):
    """The insertDataset phase log block (HashTable.cpp:50-80)."""
    from .utils.timing import phase_clock
    with phase_clock("insertDataset", log=log, src=__file__):
        u = ds.number_of_unique_reads
        p, collisions, longest, rid, orient, cps = simulate(ds, min_overlap)
        log("Hash Table size set to: %d" % p)
        for i, c in enumerate(cps):
            log("%10d reads inserted in the hash table. Hash collisions: "
                "%10d" % ((i + 1) * 1000000, c))
        log("")
        log("Total Hash collisions: %d" % collisions)
        log("Longest list size in the hash table is: %d" % longest)
        log("Read: ")
        if longest > 0:
            log(ds.read_strs[rid].decode())
            import metagenomics_tpu_torch.ops.packing as packing
            log(packing.codes_to_ascii(ds.codes_rev[rid],
                                       int(ds.lengths[rid])).decode())
            log("Orientation: %d" % orient)
