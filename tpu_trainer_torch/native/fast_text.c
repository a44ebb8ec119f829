/* Host text pipeline: byte-level tokenize + shard in one pass.
 *
 * Performs "per line: strip -> byte ids -> append EOS" (the ByteTokenizer
 * semantics of tpu_trainer_torch/utils/tokenizer.py) over a whole file
 * buffer, with the streaming loaders' line-modulo host sharding
 * (line_idx % num_shards == shard_id) applied inline. Loaded via ctypes;
 * the Python loop in tpu_trainer_torch/data/text.py stays the reference
 * for the semantics.
 *
 * Build: cc -O3 -shared -fPIC fast_text.c -o libfast_text-<hash>.so
 * (done on demand by tpu_trainer_torch/native/__init__.py).
 */

#include <stdint.h>
#include <stddef.h>

static int is_space(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' ||
           c == '\v' || c == '\f';
}

/* Tokenize `data[0..n)` line by line into `out` (int32 ids).
 *
 * For every non-empty (post-strip) line whose index satisfies
 * line_idx % num_shards == shard_id: emit its stripped bytes as ids
 * followed by eos_id. Returns the number of ids written. `out` must have
 * room for n + number_of_lines + 1 entries (worst case).
 *
 * If max_tokens >= 0, stops after writing max_tokens ids (the streaming
 * loaders' token budget, reference tinystories.py:103-108).
 *
 * Returns -1 when the buffer contains bytes whose semantics under
 * Python's text processing differ from this byte loop — non-ASCII
 * (Unicode whitespace / invalid UTF-8 replacement), '\r' (universal
 * newlines), or exotic ASCII whitespace (0x1c-0x1f, stripped by
 * str.strip()). The caller then uses the pure-Python reference path, so
 * native-vs-Python can never produce different training data.
 */
long fast_byte_tokenize(const unsigned char *data, long n, int32_t eos_id,
                        long shard_id, long num_shards, long max_tokens,
                        int32_t *out) {
    long w = 0;       /* ids written */
    long line = 0;    /* line index */
    long i = 0;
    if (num_shards <= 0) num_shards = 1;
    for (long j = 0; j < n; j++) {
        unsigned char c = data[j];
        if (c >= 0x80 || c == '\r' || (c >= 0x1c && c <= 0x1f))
            return -1;  /* semantics not byte-exact: use the Python path */
    }
    while (i < n) {
        /* find end of line */
        long start = i;
        while (i < n && data[i] != '\n') i++;
        long end = i;          /* [start, end) excludes the newline */
        if (i < n) i++;        /* skip the newline */
        if (line % num_shards == shard_id) {
            /* strip */
            while (start < end && is_space(data[start])) start++;
            while (end > start && is_space(data[end - 1])) end--;
            if (end > start) {
                for (long j = start; j < end; j++) {
                    if (max_tokens >= 0 && w >= max_tokens) return w;
                    out[w++] = (int32_t)data[j];
                }
                if (max_tokens >= 0 && w >= max_tokens) return w;
                out[w++] = eos_id;
            }
        }
        line++;
    }
    return w;
}

/* Count lines (for sizing the output buffer). */
long fast_count_lines(const unsigned char *data, long n) {
    long lines = 0;
    for (long i = 0; i < n; i++)
        if (data[i] == '\n') lines++;
    return lines + 1;
}
