/* Asynchronous file I/O worker pool for the NVMe offload tier.
 *
 * Copy of deepspeed_tpu/ops/csrc/aio.c for the PyTorch port (bound by
 * deepspeed_tpu_torch/ops/aio/__init__.py over CPU torch tensors), with
 * byte counters: ds_aio_stats reports how many bytes each direction moved
 * through O_DIRECT and how many buffered.
 *
 * Native analogue of the reference's libaio-based engine (csrc/aio/py_lib/
 * deepspeed_aio_thread.cpp, deepspeed_py_aio_handle.cpp): a pool of POSIX
 * threads services pread/pwrite requests from a mutex+condvar queue so
 * device<->host<->disk stages overlap; aligned requests take O_DIRECT for
 * their bulk (see run_request) so swap working sets >> page cache avoid the
 * double copy. The scheduling benefit (overlap with the host Adam step and
 * the TPU transfers) comes from the thread pool; io_uring/io_submit would
 * only relocate the queue into the kernel.
 *
 * API (ctypes-bound in deepspeed_tpu/ops/aio/__init__.py):
 *   ds_aio_create(threads) -> handle
 *   ds_aio_submit(h, path, buf, nbytes, file_offset, is_write) -> 0/-1
 *   ds_aio_wait(h) -> number of failed requests since last wait
 *   ds_aio_stats(h, out[4]) -> bytes read / written with O_DIRECT, read /
 *                              written buffered, since create
 *   ds_aio_destroy(h)
 */

#define _GNU_SOURCE
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

typedef struct req {
    char *path;
    char *buf;
    int64_t nbytes;
    int64_t offset;
    int is_write;
    struct req *next;
} req_t;

typedef struct {
    pthread_mutex_t mu;
    pthread_cond_t work_cv;   /* signalled when a request is queued */
    pthread_cond_t done_cv;   /* signalled when in_flight drops */
    req_t *head, *tail;
    int64_t in_flight;        /* queued + executing */
    int64_t failed;
    int64_t bytes[4];         /* direct read, direct write, buffered read, buffered write */
    int shutdown;
    int nthreads;
    pthread_t *threads;
} ds_aio_t;

#define DS_AIO_ALIGN 4096

static int do_io(int fd, req_t *r, int64_t start, int64_t end) {
    int64_t done = start;
    while (done < end) {
        ssize_t n = r->is_write
            ? pwrite(fd, r->buf + done, (size_t)(end - done), r->offset + done)
            : pread(fd, r->buf + done, (size_t)(end - done), r->offset + done);
        if (n <= 0) return -1;
        done += n;
    }
    return 0;
}

/* O_DIRECT when the request allows it (reference csrc/aio uses libaio +
 * O_DIRECT; for swap working sets >> page cache, buffered IO double-copies
 * through it). Strategy: when buffer AND file offset are 4096-aligned, the
 * largest aligned PREFIX goes through an O_DIRECT fd and only the tail is
 * buffered — so arbitrary request lengths still bypass the cache for their
 * bulk. Any O_DIRECT failure (unsupported fs, tmpfs, misalignment raced by
 * the kernel) falls back to fully buffered, never to an error. */
static void count(int64_t *bytes, int is_write, int direct, int64_t n) {
    if (n > 0) __atomic_fetch_add(&bytes[(direct ? 0 : 2) + (is_write ? 1 : 0)], n, __ATOMIC_RELAXED);
}

static int run_request(req_t *r, int64_t *bytes) {
    int flags = r->is_write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    int64_t direct_end = 0;
    if ((((uintptr_t)r->buf | (uintptr_t)r->offset) & (DS_AIO_ALIGN - 1)) == 0)
        direct_end = r->nbytes & ~(int64_t)(DS_AIO_ALIGN - 1);
    if (direct_end > 0) {
        int dfd = open(r->path, flags | O_DIRECT, 0644);
        if (dfd >= 0) {
            int rc = do_io(dfd, r, 0, direct_end);
            close(dfd);
            if (rc != 0) direct_end = 0;  /* mid-stream EINVAL: redo buffered */
        } else {
            direct_end = 0;
        }
    }
    count(bytes, r->is_write, 1, direct_end);
    if (r->nbytes > 0 && direct_end >= r->nbytes) return 0;
    /* nbytes == 0 still opens with O_CREAT below: an empty write
     * must create the file (fallback-path parity) */
    int fd = open(r->path, flags, 0644);
    if (fd < 0) return -1;
    int rc = do_io(fd, r, direct_end, r->nbytes);
    close(fd);
    if (rc == 0) count(bytes, r->is_write, 0, r->nbytes - direct_end);
    return rc;
}

static void *worker(void *arg) {
    ds_aio_t *h = (ds_aio_t *)arg;
    for (;;) {
        pthread_mutex_lock(&h->mu);
        while (!h->head && !h->shutdown)
            pthread_cond_wait(&h->work_cv, &h->mu);
        if (!h->head && h->shutdown) {
            pthread_mutex_unlock(&h->mu);
            return NULL;
        }
        req_t *r = h->head;
        h->head = r->next;
        if (!h->head) h->tail = NULL;
        pthread_mutex_unlock(&h->mu);

        int rc = run_request(r, h->bytes);

        pthread_mutex_lock(&h->mu);
        if (rc != 0) h->failed++;
        h->in_flight--;
        pthread_cond_broadcast(&h->done_cv);
        pthread_mutex_unlock(&h->mu);
        free(r->path);
        free(r);
    }
}

ds_aio_t *ds_aio_create(int nthreads) {
    if (nthreads < 1) nthreads = 1;
    ds_aio_t *h = (ds_aio_t *)calloc(1, sizeof(ds_aio_t));
    pthread_mutex_init(&h->mu, NULL);
    pthread_cond_init(&h->work_cv, NULL);
    pthread_cond_init(&h->done_cv, NULL);
    h->nthreads = nthreads;
    h->threads = (pthread_t *)calloc((size_t)nthreads, sizeof(pthread_t));
    for (int i = 0; i < nthreads; i++)
        pthread_create(&h->threads[i], NULL, worker, h);
    return h;
}

int ds_aio_submit(ds_aio_t *h, const char *path, char *buf, int64_t nbytes,
                  int64_t offset, int is_write) {
    req_t *r = (req_t *)malloc(sizeof(req_t));
    if (!r) return -1;
    r->path = strdup(path);
    r->buf = buf;
    r->nbytes = nbytes;
    r->offset = offset;
    r->is_write = is_write;
    r->next = NULL;
    pthread_mutex_lock(&h->mu);
    if (h->tail) h->tail->next = r; else h->head = r;
    h->tail = r;
    h->in_flight++;
    pthread_cond_signal(&h->work_cv);
    pthread_mutex_unlock(&h->mu);
    return 0;
}

int64_t ds_aio_wait(ds_aio_t *h) {
    pthread_mutex_lock(&h->mu);
    while (h->in_flight > 0)
        pthread_cond_wait(&h->done_cv, &h->mu);
    int64_t failed = h->failed;
    h->failed = 0;
    pthread_mutex_unlock(&h->mu);
    return failed;
}

void ds_aio_stats(ds_aio_t *h, int64_t *out) {
    for (int i = 0; i < 4; i++) out[i] = __atomic_load_n(&h->bytes[i], __ATOMIC_RELAXED);
}

void ds_aio_destroy(ds_aio_t *h) {
    pthread_mutex_lock(&h->mu);
    h->shutdown = 1;
    pthread_cond_broadcast(&h->work_cv);
    pthread_mutex_unlock(&h->mu);
    for (int i = 0; i < h->nthreads; i++)
        pthread_join(h->threads[i], NULL);
    free(h->threads);
    pthread_mutex_destroy(&h->mu);
    pthread_cond_destroy(&h->work_cv);
    pthread_cond_destroy(&h->done_cv);
    free(h);
}
