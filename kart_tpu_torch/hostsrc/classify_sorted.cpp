// The host floor of the diff's classify: a merge-join over two key-sorted
// (int64 key, 20-byte oid) columns, copied from kart_tpu's native IO core
// (native/kart_io.cpp, io_classify_sorted) so that `--device cpu` runs the
// reference's own host engine. Sequential scans + memcmp. Classes: 0
// unchanged, 1 insert, 2 update, 3 delete; counts out = {inserts, updates,
// deletes}. Built with g++ by kart_tpu_torch/ops/host_classify.py.
#include <cstdint>
#include <cstring>

extern "C" {

int64_t io_classify_sorted(const int64_t* old_keys, const uint8_t* old_oids,
                           int64_t n_old, const int64_t* new_keys,
                           const uint8_t* new_oids, int64_t n_new,
                           int8_t* old_class, int8_t* new_class,
                           int64_t* counts) {
    int64_t inserts = 0, updates = 0, deletes = 0;
    int64_t i = 0, j = 0;
    while (i < n_old && j < n_new) {
        int64_t ka = old_keys[i], kb = new_keys[j];
        if (ka == kb) {
            // runs of equal keys (hash-key collisions): searchsorted pairs
            // every row with the FIRST row of the other side's run
            int64_t i0 = i, j0 = j;
            while (i < n_old && old_keys[i] == ka) {
                if (std::memcmp(old_oids + i * 20, new_oids + j0 * 20, 20) ==
                    0) {
                    old_class[i] = 0;
                } else {
                    old_class[i] = 2;
                    updates++;
                }
                i++;
            }
            while (j < n_new && new_keys[j] == ka) {
                new_class[j] =
                    std::memcmp(new_oids + j * 20, old_oids + i0 * 20, 20) == 0
                        ? 0
                        : 2;
                j++;
            }
        } else if (ka < kb) {
            old_class[i] = 3;
            deletes++;
            i++;
        } else {
            new_class[j] = 1;
            inserts++;
            j++;
        }
    }
    for (; i < n_old; i++) {
        old_class[i] = 3;
        deletes++;
    }
    for (; j < n_new; j++) {
        new_class[j] = 1;
        inserts++;
    }
    counts[0] = inserts;
    counts[1] = updates;
    counts[2] = deletes;
    return 0;
}

}  // extern "C"
