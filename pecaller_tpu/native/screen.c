/* Host-side caller window kernels: stream merge + fused phase-0 site
 * screen + coverage statistics.
 *
 * The phase-0 screen is the exact same classification the device
 * program in caller/device_screen.py::_phase0_chunk computes (simple
 * count patterns resolved against host-built exact-float64 pass
 * tables; bad-base gates of pecaller.c:1261-1304 in pure integer
 * logic), but evaluated on the host: the classification is one table
 * byte per sample, so it runs at memory bandwidth and — unlike the
 * device path — moves zero bytes over the host<->device link.  The
 * transcendental phase-1 screen and the configuration beam stay on
 * the device; only this byte-gather lives here.  Fused into the same
 * pass over the window: the .dist coverage statistics
 * (pecaller.c:1098-1131) and the EASY-site call/active outputs, which
 * otherwise each cost another full sweep of the (sites, indiv, 6)
 * window from Python.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#define S_HARD 0
#define S_EASY 1
#define S_BAD 2
#define S_UNRES 3
#define CHRY 2
#define MAX_DIST 501

/* ---------------- stream merge ---------------- */

typedef struct {
    const int64_t *pos;       /* flattened stream positions */
    const uint16_t *cnt;      /* flattened stream counts (m, 6) */
    const int64_t *offs;      /* per-stream offsets, len n_streams+1 */
    const int32_t *rank;      /* window rank array (exclusive prefix) */
    int64_t lo;
    int n_streams;
    uint16_t *data;           /* (n_pos, I, 6) */
    uint8_t *present;         /* (n_pos, I) */
    int64_t n_pos;
    int t, nt;
} merge_job_t;

static void *merge_scatter(void *argp)
{
    merge_job_t *j = (merge_job_t *)argp;
    int I = j->n_streams;
    for (int i = j->t; i < I; i += j->nt) {
        const int64_t *p = j->pos + j->offs[i];
        const uint16_t *c = j->cnt + j->offs[i] * 6;
        int64_t m = j->offs[i + 1] - j->offs[i];
        for (int64_t k = 0; k < m; k++) {
            int64_t row = (int64_t)j->rank[p[k] - j->lo];
            memcpy(j->data + (row * I + i) * 6, c + k * 6,
                   6 * sizeof(uint16_t));
            j->present[row * I + i] = 1;
        }
    }
    return 0;
}

typedef struct {
    uint16_t *data;
    uint8_t *present;
    int64_t n_pos;
    int I;
    int t, nt;
} zero_job_t;

static void *merge_zero(void *argp)
{
    /* parallel memset of the dense target BEFORE the scatter: absent
     * (site, sample) cells must read as zero counts, and a straight
     * memset beats a per-cell present check */
    zero_job_t *j = (zero_job_t *)argp;
    int64_t per = (j->n_pos + j->nt - 1) / j->nt;
    int64_t s0 = (int64_t)j->t * per;
    int64_t s1 = s0 + per < j->n_pos ? s0 + per : j->n_pos;
    if (s1 > s0) {
        memset(j->data + s0 * j->I * 6, 0,
               (size_t)(s1 - s0) * j->I * 6 * sizeof(uint16_t));
        memset(j->present + s0 * j->I, 0, (size_t)(s1 - s0) * j->I);
    }
    return 0;
}

/* Merge n_streams position-sorted pileup chunks (positions all within
 * [lo, lo+window)) into a dense (n_pos, I, 6) window.  mask/rank are
 * caller-provided scratch of `window` bytes / int32s.  Returns n_pos.
 * all_pos receives the union positions (ascending). */
int64_t merge_window(const int64_t *pos, const uint16_t *cnt,
                     const int64_t *offs, int n_streams,
                     int64_t lo, int64_t window, int nthreads,
                     uint8_t *mask, int32_t *rank,
                     int64_t *all_pos, uint16_t *data, uint8_t *present)
{
    memset(mask, 0, (size_t)window);
    for (int i = 0; i < n_streams; i++) {
        const int64_t *p = pos + offs[i];
        int64_t m = offs[i + 1] - offs[i];
        for (int64_t k = 0; k < m; k++)
            mask[p[k] - lo] = 1;
    }
    int64_t n_pos = 0;
    for (int64_t w = 0; w < window; w++) {
        rank[w] = (int32_t)n_pos;
        if (mask[w])
            all_pos[n_pos++] = lo + w;
    }
    int nt = nthreads < 1 ? 1 : (nthreads > 64 ? 64 : nthreads);
    pthread_t th2[64];
    zero_job_t zj[64];
    for (int t = 0; t < nt; t++) {
        zj[t] = (zero_job_t){data, present, n_pos, n_streams, t, nt};
        pthread_create(&th2[t], 0, merge_zero, &zj[t]);
    }
    for (int t = 0; t < nt; t++)
        pthread_join(th2[t], 0);
    nt = nthreads < 1 ? 1 : nthreads;
    if (nt > n_streams)
        nt = n_streams;
    pthread_t th[64];
    merge_job_t jobs[64];
    if (nt > 64)
        nt = 64;
    for (int t = 0; t < nt; t++) {
        jobs[t] = (merge_job_t){pos, cnt, offs, rank, lo, n_streams,
                                data, present, n_pos, t, nt};
        pthread_create(&th[t], 0, merge_scatter, &jobs[t]);
    }
    for (int t = 0; t < nt; t++)
        pthread_join(th[t], 0);
    return n_pos;
}

/* ---------------- fused screen + stats ---------------- */

typedef struct {
    const uint16_t *reads;    /* (S, I, 6) */
    const uint8_t *present;   /* (S, I) */
    const uint8_t *ref_int;   /* (S,) GEN ints; >= 4 -> HARD */
    const uint8_t *ctype;     /* (S,) */
    const uint8_t *ptab;      /* (4*5*(tmax+1)*(cmax+1),) */
    int64_t S;
    int indiv, min_depth, tmax, cmax, use_bit1;
    uint8_t *codes;           /* (S,) out */
    int8_t *out_calls;        /* (S, I): EASY rows written */
    uint8_t *out_active;      /* (S, I): EASY rows written */
    /* per-thread stat accumulators, merged by the caller of the job */
    int64_t *hist;            /* (I, MAX_DIST) */
    int64_t *mean_sum;        /* (I,) */
    int64_t *max_cov;         /* (I,) */
    int64_t *base_count;      /* (I,) */
    int t, nt;
} screen_job_t;

static void *screen_worker(void *argp)
{
    screen_job_t *j = (screen_job_t *)argp;
    int I = j->indiv;
    int tmax = j->tmax, cmax = j->cmax;
    int64_t per = (j->S + j->nt - 1) / j->nt;
    int64_t s0 = (int64_t)j->t * per;
    int64_t s1 = s0 + per < j->S ? s0 + per : j->S;
    for (int64_t s = s0; s < s1; s++) {
        const uint16_t *r = j->reads + s * I * 6;
        int ref_raw = j->ref_int[s];
        int ref = ref_raw < 3 ? ref_raw : 3;
        int64_t sum_tot = 0;
        int cnt8 = 0, all_easy = 1;
        for (int i = 0; i < I; i++) {
            const uint16_t *c = r + i * 6;
            int tot = c[0] + c[1] + c[2] + c[3] + c[4];
            int tot6 = tot + c[5];
            /* stats: coverage incl. the Ins column, absent -> 0 */
            int cov = j->present[s * I + i] ? tot6 : 0;
            j->mean_sum[i] += cov;
            if (cov > j->max_cov[i])
                j->max_cov[i] = cov;
            j->hist[i * MAX_DIST +
                    (cov < MAX_DIST ? cov : MAX_DIST - 1)]++;
            j->base_count[i] += j->present[s * I + i];
            sum_tot += tot;
            if (tot >= 8)
                cnt8++;
            if (all_easy) {
                int active = tot > j->min_depth;
                if (!active)
                    continue;
                /* simple pattern: all-ref plus <= cmax reads of ONE
                 * alternate kind, no Ins reads, depth <= tmax */
                int rr = c[ref];
                int nonref = tot - rr;
                int cbest = -1, altk = 0;
                for (int k = 0; k < 5; k++) {
                    if (k == ref)
                        continue;
                    if ((int)c[k] > cbest) {
                        cbest = c[k];
                        altk = k;
                    }
                }
                if (cbest < 0)
                    cbest = 0;
                if (nonref != cbest || c[5] != 0 || tot > tmax ||
                    cbest > cmax) {
                    all_easy = 0;
                    continue;
                }
                int flat = (((ref * 5 + altk) * (tmax + 1) + tot)
                            * (cmax + 1)) + cbest;
                int bits = j->ptab[flat];
                int pass = bits & 1;
                if (j->use_bit1)
                    pass = pass && ((bits >> 1) & 1);
                if (!pass)
                    all_easy = 0;
            }
        }
        uint8_t code;
        if (sum_tot < (int64_t)8 * I ||
            (2 * cnt8 < I && j->ctype[s] != CHRY))
            code = S_BAD;
        else if (ref_raw >= 4)
            code = S_HARD;
        else if (all_easy)
            code = S_EASY;
        else
            code = S_UNRES;
        if (code == S_EASY) {
            for (int i = 0; i < I; i++) {
                const uint16_t *c = r + i * 6;
                int tot = c[0] + c[1] + c[2] + c[3] + c[4];
                int active = tot > j->min_depth;
                j->out_active[s * I + i] = (uint8_t)active;
                j->out_calls[s * I + i] = active ? (int8_t)ref
                                                 : (int8_t)14;
            }
        } else {
            /* defaults every non-dispatched row relies on: "N 1",
             * inactive (BAD sites, and UNRES rows phase 1 turns BAD) */
            for (int i = 0; i < I; i++) {
                j->out_active[s * I + i] = 0;
                j->out_calls[s * I + i] = (int8_t)14;
            }
        }
        /* BAD outranks everything except non-ACGT ref, which the
         * exact engine must classify (matches _phase0_chunk order:
         * bad ? BAD : easy ? EASY : UNRES, then ref>=4 -> HARD) */
        if (ref_raw >= 4)
            code = S_HARD;
        j->codes[s] = code;
    }
    return 0;
}

void screen_stats_window(const uint16_t *reads, const uint8_t *present,
                         const uint8_t *ref_int, const uint8_t *ctype,
                         const uint8_t *ptab, int64_t S, int32_t indiv,
                         int32_t haploid, int32_t tmax, int32_t cmax,
                         int32_t use_bit1, int32_t nthreads,
                         uint8_t *codes, int8_t *out_calls,
                         uint8_t *out_active, int64_t *hist,
                         int64_t *mean_sum, int64_t *max_cov,
                         int64_t *base_count)
{
    int nt = nthreads < 1 ? 1 : (nthreads > 16 ? 16 : nthreads);
    pthread_t th[16];
    screen_job_t jobs[16];
    /* per-thread private accumulators (I * MAX_DIST + 3I int64) */
    int64_t *acc = (int64_t *)calloc(
        (size_t)nt * indiv * (MAX_DIST + 3), sizeof(int64_t));
    for (int t = 0; t < nt; t++) {
        int64_t *a = acc + (int64_t)t * indiv * (MAX_DIST + 3);
        jobs[t] = (screen_job_t){
            reads, present, ref_int, ctype, ptab, S, indiv,
            haploid ? 1 : 2, tmax, cmax, use_bit1, codes, out_calls,
            out_active, a, a + (int64_t)indiv * MAX_DIST,
            a + (int64_t)indiv * (MAX_DIST + 1),
            a + (int64_t)indiv * (MAX_DIST + 2), t, nt};
        pthread_create(&th[t], 0, screen_worker, &jobs[t]);
    }
    for (int t = 0; t < nt; t++) {
        pthread_join(th[t], 0);
        int64_t *a = acc + (int64_t)t * indiv * (MAX_DIST + 3);
        for (int i = 0; i < indiv; i++) {
            for (int d = 0; d < MAX_DIST; d++)
                hist[i * MAX_DIST + d] += a[i * MAX_DIST + d];
            mean_sum[i] += a[(int64_t)indiv * MAX_DIST + i];
            int64_t mx = a[(int64_t)indiv * (MAX_DIST + 1) + i];
            if (mx > max_cov[i])
                max_cov[i] = mx;
            base_count[i] += a[(int64_t)indiv * (MAX_DIST + 2) + i];
        }
    }
    free(acc);
}
